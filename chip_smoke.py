#!/usr/bin/env python3
"""Drive the PyTorch port's SPA-Cache decode and server on one CUDA card and
check them.

    python3 chip_smoke.py                 # one card, no arguments
    python3 chip_smoke.py --phases 3,7    # only those phases; no result line

Phases (each asserts; any failure exits non-zero):

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (timed);
3. every kernel against its plain PyTorch version on the card, at the
   slice shapes (B=4, N=512, d=4096, r=128, 32 heads of 128, bf16,
   k in {16, 128}) and at edge shapes (ragged N, out-of-range and unsorted
   indices, GQA, window, soft_cap, kv_len, int8 K/V, f32, bf16 head_dim
   120 padded to 128 with 32 q heads on 8 kv heads), with median
   CUDA-event times of the kernel, its plain version and one PyTorch
   library call where one computes the same function (attention against
   SDPA also at kq = N = 512, the NoCache and prefill shape, and at the
   hybrid's head_dim 256 dense grid and banded prefill with a window
   mask), and the attention bodies' ``-Xptxas -v`` line.  Before every
   timed call the L2 is left holding only clean lines (``L2Flush``);
   the int8 K/V attention under bf16 q (``check_int8_attention``: the
   tensor-core int8 body at GQA groups 6, 8 and 16, windows, ragged
   kv_len with a 0 row, soft_cap, kq = 1 and ragged, head_dim 64 and 120,
   the banded grid) against plain, timed at DeepSeek-67B's shape (kq =
   128 and 512) and InternVL2-76B's N = 1536 beside the bf16 body on bf16
   K/V; its record's launches come from phase 13's DeepSeek-67B run;
   the f32 rows (``check_f32_attention``, ``f32_row``: TF32 off for the
   library calls), each beside its f32 CUDA-core bound and the
   three-pass TF32 figure: f32 q on the same int8 K/V, f32 q and K/V at
   LLaDA-8B's heads (kq = 128 and 512, beside SDPA), the banded grid at
   phase 8's f32 local layer (hd 256, kq 2144, beside SDPA with the
   window mask) and proxy_score in f32 (beside ``torch.matmul``), with
   f32 edges (head_dim 36 and 256, GQA 1 and 8, unaligned q, k and v, f32
   scales);
   bf16 proxy_score runs one TMA-fed wgmma GEMM (proxy_wgmma: d split
   across a thread-block cluster where the row tiles do not fill the
   card, the partials summed in rank order; a score epilogue for r <= 256,
   a store epilogue for the wide projection), timed also at the hybrid's
   shape (B=2, N=16384), with its ``-Xptxas -v`` lines.
   The paged kernels (gather_pages, scatter_pages, scatter_rows_paged,
   proxy_score_paged) must match exactly, proxy_score_paged bitwise equal
   to proxy_score on the gathered pages, scatter_rows_paged also at
   256-byte, 8 KB, 10-byte and 2-byte rows and k up to 4096 (timed at
   8 KB rows and at k=4096).
   cosine_drift (r = 8 to 4096, every pairing of f32 and bf16 operands,
   ragged N, two calls the same bits) and cosine_drift_paged (bitwise
   cosine_drift on the gathered pages), each also timed L2-hot over 200
   back-to-back calls (``warm_us``), and proxy_score /
   proxy_score_paged at r=4096 (the value identifier's width: projection
   kernel + cosine_drift; paged bitwise dense), the projection alone timed
   beside one ``torch.matmul`` of the same product; at RecurrentGemma-9B's
   shapes (B=2, N=16384, 16 query heads on one kv head of 256, window
   2048) the banded sparse_attention grid (decode kq=4096 and prefill
   kq=N, bit for bit equal to the dense grid, plus f32 and int8 edges),
   the bf16 dense grid at head_dim 256, and rglru_scan (one pass over
   64-step tiles with a decoupled look-back) in bf16 and f32, forward and
   flipped, ragged T and d, with its ``-Xptxas -v`` lines;
   ssd_chunk_scan at Mamba2-370m's shapes (x [4, 4096, 32, 64], d_state
   128, chunk 256) in bf16 and f32, and with T = 200 < chunk, with the
   device time of each of its three kernels and their ``-Xptxas -v``
   lines, and its f32 row (the three-pass TF32 body: no CUDA-core
   ``ssd_chunk_*_f32`` kernel runs); the row movers (``check_row_movers``): the timing floor (a
   one-element kernel), scatter_update_multi at every commit of the
   layer step beyond its record's LLaDA K+V k=128 (k=16, H + proxy, int8
   K+V + scales, int8 H + 2-byte scale + proxy; the hybrid's 512-byte
   K+V rows and H + proxy at k=4096) bit for bit, and gather_norm beyond
   its record's k=128 (LLaDA k=16, the hybrid's k=4096 and 720, f32,
   d=1000 / 120), each timed beside its bound and plain version (scatter
   also beside ``index_copy_``), with their ``-Xptxas -v`` lines; the NaN
   rows (``check_nan_rows``): sparse_attention (bf16 and int8 K/V, and
   f32 q on f32 and int8 K/V), proxy_score and proxy_score_paged also in
   f32,
   proxy_score, proxy_score_paged, cosine_drift and gather_norm with one
   batch row's cache holding NaN, each non-finite mask equal to the plain
   version's and every other row bit-equal to a clean call;
4. decode parity: a 2-layer, full-width LLaDA, in f32 and in bf16 (the
   main path's kernel variants), through ``CudaBackend`` and
   ``TorchBackend`` (whose side of every comparison in phases 4, 8 and 10
   must count no kernel launch) must give identical tokens and step
   counts, for ``SPACache`` and for every baseline strategy (value,
   query, key, attn_in, window, attn_out, the incremental identifier); in
   f32 also through the paged cache (full-length and mixed-``kv_len``
   rows);
5. the main path: LLaDA-8B (32 layers, bf16, random weights from a seed),
   B=4, prompt 256 + gen 256, ``DecodeSession.run`` with ``SPACache``
   (adaptive, r=128), the confidence scheduler and ``CudaBackend``; every
   slot must commit, the hidden states stay finite and every kernel of the
   path must have launched; then 16 steps of the ``NoCache`` baseline;
6. the baselines: the same decode on LLaDA-8B's first 8 layers
   (``llada_cut``: phases 6, 7, 12, 14 and 15 serve many steps, and at
   this depth they fit the script's time limit) under each baseline
   strategy (the config's adaptive budget; value and the incremental identifier to
   completion, the others for 64 steps), ms/step and generated tokens/s
   each, a ``torch.profiler`` window on each; hidden states finite, the
   path's new kernels launched; then all of them and SPA side by side in
   rotating blocks (wall ms/step comparable within the call);
7. on the same 8 layers, what paging costs a step (the main path's
   decode on a dense cache and on the pool, in turns), then the server:
   the same model and proxies through ``ServingEngine`` over
   the paged pool (canvas 512, 97 pages of 16, 4 slots), nine requests of
   mixed lengths, 1.67x the pool, one of them a priority-5 arrival that
   must preempt; all complete, the pool drains, every paged kernel
   launched, with a ``torch.profiler`` window over a few engine steps;
   then paged lanes of attn_in, the incremental identifier and attn_out
   (five mixed requests each), which launch cosine_drift_paged, with a
   ``torch.profiler`` window over a few engine steps of the attn_in lane;
8. hybrid parity: a 3-layer, full-width RecurrentGemma (rglru, rglru,
   local) at B=2, N=16384, whose local layer runs the banded grid,
   through ``CudaBackend`` and ``TorchBackend``: f32 free-running with
   identical tokens, bf16 in lockstep (strict);
9. the hybrid main path: RecurrentGemma-9B (38 layers, bf16, random
   weights), B=2, prompt 16128 + gen 256, ``DecodeSession.run`` with
   ``SPACache`` and ``CudaBackend`` for 32 steps (hidden states finite;
   the banded grid, the dense grid and rglru_scan launched, counted per
   step), a profiled window, then NoCache steps (SPA/NoCache on wall and
   device time);
10. Mamba2 parity: a 3-layer, full-width Mamba2 (SSD blocks only, NoCache)
   at B=4, N=4096, through ``CudaBackend`` and ``TorchBackend``: f32
   free-running with identical tokens and the final hidden states within
   1e-5 of their largest value (each backend's decode wall, and the f32
   scan's device us a call and launches a step in one forward), bf16 in
   lockstep;
11. the Mamba2 main path: Mamba2-370m (48 SSD layers, bf16, random
   weights), B=4, prompt 3840 + gen 256, ``DecodeSession.run`` with the
   config's ``NoCache`` and ``CudaBackend`` for 32 steps: exactly two
   ssd_chunk_scan launches a layer a step, hidden states finite, ms/step,
   generated tokens/s and a profiled window (cuBLAS, ssd_chunk_scan, other
   kernels, device-busy share);
12. shared-prefix serving, run after phase 7 (it shares LLaDA-8B's
   weights and proxies with phases 5-7): (a) a 2-layer, full-width f32 LLaDA through
   ``ServingEngine`` (canvas 64, pages of 16, 2 slots) with the prefix
   index on and off, on a system prompt of 2 pages and 3 questions asked
   twice: every page a hit attaches must equal, bit for bit, the
   publisher's prefill-time page it was copied from; an admission must
   launch ``sparse_attention`` once a layer for each group of cold or
   partial rows, over a partial row's suffix only, and never for full
   hits alone; a suffix-only prefill over the cold prefill's prefix K/V
   must give the cold prefill's suffix rows within 1e-5; prints how many
   hits decode the prefix-off tokens; (b) LLaDA-8B's 8 layers through
   ``ServingEngine`` (canvas 512, pages of 16, 4 slots, 257 pages) on the
   shared-system-prompt traffic (224-token system prompt, 6 questions of
   32 tokens asked twice, gen 256), prefix index off and on, each after
   an untimed warm pass (8 steps a request) and with the index dropped:
   every request finishes with no [MASK] left; prints hits, the prefill
   device ms of an admitted row (cold, suffix-only), the copy-on-write
   and publication copies a page, engine ms per step, TTFT and e2e
   percentiles and generated tokens/s;
13. the dense configs at full width, each after a 2-layer parity of
   ``CudaBackend`` and ``TorchBackend`` (f32 free-running with identical
   tokens, an int8 cache's codes within 1; bf16 in lockstep): Dream-7B (28
   layers, B=4, prompt 256 + gen 256, GQA 28/4, r=32), Gemma2-2B (26
   layers, local and global, softcaps, post-norms, head_dim 256) and
   H2O-Danube3-4B (24 layers, sliding window, head_dim 120) at B=2, prompt
   7936 + gen 256 (their 8192 context; the 4096 window masks keys but
   leaves no band), DeepSeek-67B cut to 16 of 95 layers (int8 cache, GQA
   64/8) at B=4, prompt 256 + gen 256; random bf16 weights, each config's
   own ``spa``, 16 SPA then 4 NoCache steps: hidden states finite, every
   kernel of the path launched, the dense attention grid once a layer at
   prefill and a step and no banded call, a step whose windows mask some
   (query, key) pairs; ms a step, device ms and busy share over 4 SPA
   steps, the per-layer k and launches a step; weights freed between
   configs;
14. the host-RAM page tier under the prefix index, after phase 12 on the
   same weights: (a) a 2-layer full-width f32 LLaDA through
   ``ServingEngine`` (canvas 64, pool 13 pages of 16, host tier f32):
   promoted pages bitwise what their demotion read, the repeats' tokens
   those of an engine that never evicts, an int8 round trip on the card
   within max|row|/254 plus the f16 scale's cast, every host slot
   corrupted before the repeats raising on its checksum and served cold,
   both tiers leak-free and emptied by ``drop_prefix_cache``; (b) LLaDA-8B's
   8 layers on the JAX serving benchmark's host-tier traffic scaled 16x in tokens
   (8 requests, prompt 64-176, gen 64-256, waves of 2 slots, canvas 512,
   60 pages of 16, host budget the prefix set's pages, 16 steps a
   request), a warm then a measured pass with the tier off, at f32 and at
   auto: more full hits with the tier on; prints the tier's counters and
   each demotion's and promotion's copy, checksum and quantization times
   (host and device) and copy rate, and ms per engine step;
15. online serving, after phase 14 on the same weights: (a) a 2-layer
   full-width f32 LLaDA through ``ServingEngine`` at the JAX serving
   benchmark's online shape (canvas 32, pages of 4, 34 pages, 4 slots,
   prefix index on, ``refresh_interval=1``, ``StepClock``) on its Poisson
   and bursty traces (``poisson_arrivals``, ``bursty_arrivals``), FIFO and
   ``SLOPolicy(boost=2, urgency_frac=0.6)``, each through ``CudaBackend``
   and ``TorchBackend``: identical event streams and shed sets across the
   backends, byte-identical outputs of every request both passes
   complete, SLO-aware goodput at least FIFO's, a traced pass
   (``dynamics_every=1``) with the same events; (b) LLaDA-8B's 8 layers
   (canvas 512,
   130 pages of 16, 4 slots, ``refresh_interval=1``) on the Poisson trace
   x16 in tokens and virtual time (its first 7 requests), FIFO then
   SLO-aware: every stream
   covers each gen position once and equals its output, the pool drains
   to the index's pages, the serving kernels launch, the SLO-aware pass
   boosts, preempts or sheds at least once; prints goodput, TTFT
   / TPOT in steps, wall ms an engine step, the ``dispatch`` /
   ``host_overlap`` / ``host_sync`` span medians, the streaming and
   ``cache_dynamics`` costs and how many outputs the passes share; (c) an
   ``AsyncFrontend`` on 127.0.0.1 over the same 8 layers (the config's SPA
   schedule, real clock, tracer on) with six HTTP clients, one hanging up
   after its first token: streams equal their ``done`` outputs, the
   dropped request canceled with its pages freed, ``/metrics`` Prometheus
   text, the debug views JSON mid-stream, the exported trace's step spans
   inside the serving window; prints TTFT / TPOT in ms, ms an engine step
   online and offline, the event delivery latency and the share of steps
   still on the card when ``_host_overlap`` ended;
16. fault injection and the supervisor, after phase 15 on the same
   weights: (a) the JAX serving benchmark's fault storm (part 5: its six
   requests, canvas 32, pages of 4, 41 pages, host tier of 16 pages in
   f32, 4 slots, ``refresh_interval=1``) on a 2-layer full-width f32
   LLaDA, clean then under ``FAULT_STORM``, through ``CudaBackend`` and
   ``TorchBackend``: the same injector log, aborted uids, counters and
   outputs on both, survivors byte-identical to the clean pass, a
   poisoned page handed out again, both tiers drained, and the counters
   of the JAX engine (``FAULT_STORM_RECORD``); (b) LLaDA-8B, all 32
   layers (canvas 256,
   73 pages of 16, host tier of 32 pages, 4 slots, the config's SPA with
   ``refresh_interval=1``) on five of those requests x8 in tokens and two
   repeats, clean under ``supervise=True``, then under ``FAULT_PLAN``
   (all six sites) and ``FAULT_SUPERVISOR``: the rehearsal's log, aborted
   and canceled uids and ladder walk (``FAULT_EXPECT``), a NaN
   quarantine, a cold prefill after the corrupted page, a watchdog
   recovery, an invariant check every iteration, both tiers drained;
   prints survivors equal to their clean twins, ms a step of both passes
   and the ``supervisor`` span's median;
17. profiling through the server and the recurrent lanes (see
   ``profiling_serving``, ``recurrent_exactness``, ``recurrent_full_width``);
18. MoE and VLM at full width, each config's first 8 layers (bf16 random
   weights, its own ``spa`` and int8 cache, ``CudaBackend``): (a)
   Mixtral-8x22B and Qwen3-MoE-235B-A22B at B=4, prompt 256 + gen 256, 16
   SPA then 4 NoCache steps: hidden states finite, every kernel of the
   path launched, one attention call a layer at prefill and a step; ms a
   step, device ms a step by group (expert products, routing / gather /
   combine, attention, the SPA kernels, other) and the busy share over 4
   SPA steps, assignments dropped to capacity a step; layer 0's MoE twice
   bit for bit, its combine equal to a plain sum in expert order; (b) Qwen3-MoE's cut
   through ``ServingEngine`` (paged, pages of 16, prefix index on, 4
   requests of gen 32, the last repeating the first: a full hit that
   decodes the first request's tokens); (c) InternVL2-76B with 1024 patch
   embeddings from a seed + prompt 256 + gen 256, as (a);
19. training, the forward and backward on ``TorchBackend`` (no kernel
   launched), AdamW: (a) InternLM2-1.8B at full size, B=8, seq 512, 6
   steps; (b) the JAX ``tests/test_system.py`` recipe (the tiny reduced
   InternLM2, 200 steps: the loss falls; then decoded through the CUDA
   kernels, SPA agreeing with vanilla on more than 60% of tokens and
   computing fewer rows); (c) Qwen3-MoE at full width with 1 layer, B=8,
   seq 256, 8 microbatches, 2 steps, the aux loss in the total; (d)
   HuBERT-XLarge at full depth, ``encoder_loss``, B=4, 1024 frames, 4
   steps.  Each step's loss and gradient norm finite and no step skipped;
   ms a step, tokens a second and peak memory;
20. the dry run (``launch/dryrun.py``), fake CUDA tensors on the card's
   host: (a) InternLM2-1.8B at full size, decode_32k and train_4k on the
   fake 16 x 16 mesh and decode_32k on the 2 x 16 x 16 one, each ``ok``
   with collectives, its argument bytes the sum of the rules' local
   shards; (b) ``launch/hillclimb.py`` baseline and int8_cache on its
   decode_32k with a store under ``build/`` (int8 holds less; baseline
   again is a warm start); (c) its decode at B=4, N=4096 on the 1 x 1
   host mesh against the same step run for real: argument bytes equal to
   the real params and state, FLOPs equal to ``FlopCounterMode`` through
   ``TorchBackend``, and the predicted peak memory and roofline time
   beside the card's (``CudaBackend``, which launches proxy_score,
   gather_norm, sparse_attention and scatter_update_multi).

Phase 3 also times ``scatter_pages`` beside one ``index_put_`` of the
whole view (``arena[:, pt] = dense``), its library call.

Every profiled window (phases 5, 6, 7, 9, 11, 13) prints each kernel group's
device ms a step, calls a step and device us a call.

The last lines are the kernels' JSON record (each kernel's launches are
those of its path: phase 5 for the session kernels, phase 6 for
cosine_drift and the wide proxy_score, phase 7's first server for the
paged kernels and its drift lanes for cosine_drift_paged, phase 9 for
the banded grid and rglru_scan, phase 11 for ssd_chunk_scan), the card
line and ``{"ok": true, "device": {...}}``.  Each phase prints its wall
seconds, and the script its total before the JSON lines.  Without a CUDA device, or without
the repository's ``src/`` beside it, the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, dense bf16 tensor FLOP/s
# and f32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

SLICE = dict(B=4, N=512, d=4096, r=128, H=32, KVH=32, hd=128)
# RecurrentGemma-9B's decode: B=2, canvas 16128 + 256
HYBRID = dict(B=2, N=16384, d=4096, H=16, KVH=1, hd=256, window=2048)
PAGE = 16                 # rows per cache page of the serving pool
# kernels of the main path (DecodeSession.run) and of the serving path
# (ServingEngine over the paged pool); each path's launches are counted
# from zero just before it runs
SESSION_KERNELS = ("proxy_score", "gather_norm", "sparse_attention",
                   "scatter_update_multi")
SERVING_KERNELS = ("gather_pages", "scatter_pages", "scatter_rows_paged",
                   "proxy_score_paged", "gather_norm", "sparse_attention",
                   "scatter_update_multi")
# kernels of the baselines phase (DecodeSession.run under each baseline
# strategy) and of the server's drift lanes
BASELINE_KERNELS = ("cosine_drift", "proxy_score_wide")
DRIFT_LANE_KERNELS = ("cosine_drift_paged",)
HYBRID_ONLY_KERNELS = ("sparse_attention_banded", "rglru_scan")
BASELINES = ("value", "query", "key", "attn_in", "window", "attn_out",
             "singular_incremental")
# the kernels each baseline's decode must launch (gather_norm and the
# commits run under every one of them but attn_out)
BASELINE_NEEDS = {"value": ("proxy_score_wide", "cosine_drift"),
                  "query": ("proxy_score_wide", "cosine_drift"),
                  "key": ("proxy_score_wide", "cosine_drift"),
                  "attn_in": ("cosine_drift", "gather_norm"),
                  "window": ("gather_norm", "sparse_attention"),
                  "attn_out": ("cosine_drift", "sparse_attention"),
                  "singular_incremental": ("cosine_drift", "gather_norm")}
BASELINE_STEPS = 64       # steps of the baselines not run to completion
# kernels of the hybrid path (RecurrentGemma-9B, DecodeSession.run)
HYBRID_KERNELS = ("proxy_score", "gather_norm", "sparse_attention",
                  "sparse_attention_banded", "scatter_update_multi",
                  "rglru_scan")
HYBRID_STEPS = 32         # SPA steps of the hybrid main path
# Mamba2-370m's decode: B=4, prompt 3840 + gen 256 = N (16 chunks of 256)
MAMBA = dict(B=4, N=4096, H=32, hd=64, ds=128, chunk=256)
MAMBA_KERNELS = ("ssd_chunk_scan",)
MAMBA_GEN = 256
MAMBA_STEPS = 32          # NoCache steps of the Mamba2 main path
HYBRID_GEN = 256          # hybrid: prompt 16128 + gen 256 = N
GEN_LEN = 256             # main path: prompt 256 + gen 256 = N
CUT_LAYERS = 8            # LLaDA-8B's depth in phases 6, 7, 12, 14, 15
SPIN_CYCLES = 4_000_000   # ~2 ms of a spin kernel at H100 clocks


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


class L2Flush:
    """Run before every timed call of :func:`median_ms`: it leaves the
    H100's L2 (50 MB, write-back) holding only clean lines of a buffer that
    no timed call touches, so a call reads its inputs from HBM, as on the
    decode path, and writes back nothing but its own stores.
    ``zero_()`` of a 64 MB buffer alone left the L2 full of dirty lines,
    and a call that read X bytes then also wrote back up to X dirty bytes
    between its events; the read sweep of a second 64 MB buffer (a sum
    into a preallocated scalar) evicts those lines before the timed call's
    spin kernel starts."""

    def __init__(self, torch):
        self.torch = torch
        self.written = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                   device="cuda")
        self.swept = torch.ones(16 * 2 ** 20, dtype=torch.float32,
                                device="cuda")
        self.total = torch.zeros((), dtype=torch.float32, device="cuda")

    def __call__(self) -> None:
        self.written.zero_()
        self.torch.sum(self.swept, 0, out=self.total)


def median_ms(fn, torch, flush, runs: int = 30, warmup: int = 3) -> float:
    """Median device time of one call, from CUDA events.  ``flush`` (an
    :class:`L2Flush`) runs before every timed call, so inputs come from
    HBM and the L2 holds no dirty line, and a spin kernel ahead of the
    start event keeps the card busy while the host enqueues the call, so
    the events bracket device work and not Python dispatch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def printed_ms(label: str, fn, torch, flush, **kw) -> float:
    """:func:`median_ms`, printed under ``label``."""
    ms = median_ms(fn, torch, flush, **kw)
    print(f"  {label}: {ms:.4f} ms")
    return ms


def warm_us(fn, torch, kernel: str, calls: int = 200) -> tuple:
    """(device us a call, launches traced) of the kernels whose names hold
    ``kernel``, over ``calls`` back-to-back calls with no flush between
    them, from a ``torch.profiler`` trace: the operands may stay in the L2
    (50 MB on the H100), as where a step's kernels follow each other
    closely.  The clean-flush time is the decode path's today; this one is
    what CUDA graphs may make of it.  The trace may drop a launch or all
    of them, so the mean is over those it holds (None where it holds
    none)."""
    from torch.autograd import DeviceType
    fn()
    torch.cuda.synchronize()
    with new_profiler(torch) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    t = n = 0
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and kernel in ev.key:
            dt = getattr(ev, "self_device_time_total", None)
            t += ev.self_cuda_time_total if dt is None else dt
            n += ev.count
    return (t / n if n else None), n


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def bound(nbytes: float, flops: float, flops_per_s: float = BF16_FLOPS):
    """(least ms, "bytes" or "operations") on the H100: bf16 tensor-core
    work by default, f32 CUDA-core work with ``F32_FLOPS``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_lines(pattern: str) -> dict:
    """``-Xptxas -v`` lines (registers, stack, spills) of the kernels whose
    mangled name matches ``pattern``, keyed by the match (its first group
    where it has one), from the build log."""
    from repro_torch.kernels import _lib
    found, entry = {}, "?"
    for line in _lib.build_log().splitlines():
        if line.startswith("== "):      # the next source file's output
            entry = "?"
            continue
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            continue
        m = re.search(pattern, entry)
        if m and ("registers" in line or "spill" in line):
            found.setdefault(m.group(1) if m.groups() else m.group(0),
                             []).append(line.split(":", 1)[-1].strip()
                                        if "ptxas" in line else line.strip())
    return found


def attention_ptxas() -> str:
    """``-Xptxas -v`` of the wgmma attention bodies (bf16 and int8 K/V under
    bf16 q, f32 and int8 K/V under f32 q in TF32), one entry per head_dim
    width: registers, stack and spills (from the build log)."""
    found = ptxas_lines(r"attention_((?:bf16|i8)_wgmmaILi\d+|"
                        r"tf32_wgmmaILi\d+ELb[01])E")

    def key(name):
        kind, width = name.split("_wgmmaILi")
        if kind == "tf32":
            width, i8 = width.split("ELb")
            kind = "f32-q int8" if i8 == "1" else "f32-q f32"
        return kind, int(width)
    return "; ".join(f"{key(k)[0]} hd {key(k)[1]}: " + ", ".join(v)
                     for k, v in sorted(found.items(),
                                        key=lambda kv: key(kv[0])))


def wgmma_ptxas() -> str:
    """``-Xptxas -v`` of the bf16 proxy_score body (proxy_wgmma), one entry
    per (columns, epilogue, row addressing)."""
    found = ptxas_lines(r"(proxy_wgmmaILi\d+ELb[01]ENS_9(?:Dense|Paged)Rows)")

    def name(key):
        n, e, rows = re.match(r"proxy_wgmmaILi(\d+)ELb([01])ENS_9(\w+)",
                              key).groups()
        return f"<{n}, {'score' if e == '1' else 'store'}, {rows}>"
    return "; ".join(f"{name(k)}: " + ", ".join(v)
                     for k, v in sorted(found.items()))


def lookback_ptxas() -> str:
    """``-Xptxas -v`` of rglru_lookback, bf16 and f32."""
    found = ptxas_lines(r"(rglru_lookbackI(?:13__nv_bfloat16|f))")
    return "; ".join(f"{'bf16' if 'bfloat16' in k else 'f32'}: "
                     + ", ".join(v)
                     for k, v in sorted(found.items()))


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(torch, flush):
    import torch.nn.functional as F
    from repro_torch.kernels import _lib
    from repro_torch.kernels import proxy_score as ps
    from repro_torch.kernels import scatter_update as sc
    from repro_torch.kernels import sparse_attention as sa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def randint(lo, hi, *shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)

    def assert_close(name, got, want, atol, rtol):
        err = max_err(got, want)
        lim = atol + rtol * float(want.float().abs().max())
        print(f"  {name}: max_abs_err {err:.3e} (limit {lim:.3e})")
        assert err <= lim, f"{name}: {err} > {lim}"
        return err

    records = {}
    B, N, d, r = SLICE["B"], SLICE["N"], SLICE["d"], SLICE["r"]
    H, KVH, hd = SLICE["H"], SLICE["KVH"], SLICE["hd"]

    # -- proxy_score ------------------------------------------------------
    # bf16 tolerance: kernel and plain round p to bf16 after summing in a
    # different order, so p may differ by one bf16 ulp (2^-8 relative) and
    # the cosine by ~1e-3.
    print("proxy_score")
    x = randn(B, N, d)
    w = randn(d, r, scale=0.05)
    pc = randn(B, N, r)
    s_k, p_k = ps.proxy_score(x, w, pc)
    s_p, p_p = ps.proxy_score_plain(x, w, pc)
    err = max(assert_close("slice scores", s_k, s_p, 5e-3, 0),
              assert_close("slice p_now", p_k, p_p, 0, 1e-2))
    # unchanged rows tie at cosine 1 (the identifier's premise)
    s1, _ = ps.proxy_score(x, w, p_k)
    assert float((s1 - 1).abs().max()) < 1e-5, "unchanged rows must score 1"
    for (b_, n_, d_, r_) in [(3, 300, 96, 16), (2, 33, 4096, 128)]:
        xe, we, pe = randn(b_, n_, d_), randn(d_, r_), randn(b_, n_, r_)
        a, bb = ps.proxy_score(xe, we, pe), ps.proxy_score_plain(xe, we, pe)
        assert_close(f"bf16 N={n_} d={d_} r={r_} scores", a[0], bb[0],
                     5e-3, 0)
        xf, wf, pf = xe.float(), we.float(), pe.float()
        a, bb = ps.proxy_score(xf, wf, pf), ps.proxy_score_plain(xf, wf, pf)
        assert_close(f"f32 N={n_} d={d_} r={r_} scores", a[0], bb[0], 1e-5, 0)
        assert_close(f"f32 N={n_} d={d_} r={r_} p_now", a[1], bb[1], 0, 1e-5)
    records["proxy_score"] = dict(
        source="src/repro_torch/csrc/proxy_score.cu",
        replaces="src/repro/kernels/proxy_score.py:101", max_abs_err=err,
        ms=printed_ms("slice shape kernel", lambda: ps.proxy_score(
            x, w, pc), torch, flush),
        plain_ms=median_ms(lambda: ps.proxy_score_plain(x, w, pc), torch,
                           flush),
        library_ms=None,
        bound=bound(2 * (B * N * d + d * r + 2 * B * N * r) + 4 * B * N,
                    2 * B * N * d * r))
    # the hybrid's shape (RecurrentGemma-9B: B=2, N=16384, d=4096, r=128):
    # 256 row tiles, d not split
    bh, nh = HYBRID["B"], HYBRID["N"]
    xh, pch = randn(bh, nh, d), randn(bh, nh, r)
    assert_close("hybrid shape scores", ps.proxy_score(xh, w, pch)[0],
                 ps.proxy_score_plain(xh, w, pch)[0], 5e-3, 0)
    ms_h = median_ms(lambda: ps.proxy_score(xh, w, pch), torch, flush)
    b_h = bound(2 * (bh * nh * d + d * r + 2 * bh * nh * r) + 4 * bh * nh,
                2 * bh * nh * d * r)
    print(f"  hybrid shape B={bh} N={nh}: kernel {ms_h:.4f} ms, bound "
          f"{b_h[0]:.4f} ms ({b_h[1]})")
    del xh, pch
    print(f"  ptxas -v: {wgmma_ptxas()}")

    # -- gather_norm --------------------------------------------------------
    # raw rows are copies (exact); normed rows round once to bf16 from f32
    # math that differs only in the sum order of mean(x^2): one bf16 ulp.
    print("gather_norm")
    h = randn(B, N, d)
    wn = randn(d, scale=0.1)
    for k in (16, 128):
        idx = torch.sort(torch.randperm(N, generator=gen, device=dev)[:k]
                         ).values.to(torch.int32).expand(B, k).contiguous()
        rk, nk = ps.gather_norm(h, idx, wn, 1e-6)
        rp, np_ = ps.gather_norm_plain(h, idx, wn, 1e-6)
        assert_close(f"k={k} rows", rk, rp, 0, 0)
        err = assert_close(f"k={k} normed", nk, np_, 0, 1e-2)
    idx_edge = torch.tensor([[5, -3, 700, 2, 511, 0, 9000, 7]] * B,
                            dtype=torch.int32, device=dev)
    for dt in (bf16, f32):
        he, we_ = h[:, :, :1000].to(dt).contiguous(), wn[:1000].to(dt)
        a, bb = ps.gather_norm(he, idx_edge, we_, 1e-6), \
            ps.gather_norm_plain(he, idx_edge, we_, 1e-6)
        assert_close(f"{dt} clamped rows", a[0], bb[0], 0, 0)
        assert_close(f"{dt} clamped normed", a[1], bb[1], 0,
                     1e-2 if dt == bf16 else 1e-5)
    records["gather_norm"] = dict(
        source="src/repro_torch/csrc/gather_norm.cu",
        replaces="src/repro/kernels/proxy_score.py:308", max_abs_err=err,
        ms=printed_ms("k=128 kernel", lambda: ps.gather_norm(
            h, idx, wn, 1e-6), torch, flush),
        plain_ms=median_ms(lambda: ps.gather_norm_plain(h, idx, wn, 1e-6),
                           torch, flush),
        library_ms=None,
        bound=bound(2 * (3 * B * 128 * d + d) + 4 * B * 128,
                    4 * B * 128 * d))

    # -- sparse_attention ---------------------------------------------------
    # both versions compute in f32 (the kernel's P to 2^-17) and round the
    # output once to bf16; the f32 sum orders differ, so an element may
    # flip by one bf16 ulp, which is at most 2^-7 of the largest output.
    # Limit: 2^-7 * max|out|.  One key masked wrongly in the 65-key window
    # below moves an output by about 1/65 of a value, several times that.
    # f32: the kernel's three-pass TF32 products (about 2^-21 of each term)
    # and sum order against the plain version's f32 products, 1e-5.
    bf16_attn_tol = dict(atol=0, rtol=2 ** -7)
    print("sparse_attention")
    kc = randn(B, N, KVH, hd)
    vc = randn(B, N, KVH, hd)
    for kq in (16, 128, 512):
        q = randn(B, kq, H, hd)
        qpos = (torch.arange(N, device=dev, dtype=torch.int32)[None]
                .expand(B, N) if kq == N else torch.sort(
                    torch.randperm(N, generator=gen, device=dev)[:kq]
                ).values.to(torch.int32).expand(B, kq).contiguous())
        a = sa.sparse_attention(q, kc, vc, qpos)
        bb = sa.sparse_attention_plain(q, kc, vc, qpos)
        err_kq = assert_close(f"kq={kq}", a, bb, **bf16_attn_tol)
        if kq == 128:
            err, q128, qpos128 = err_kq, q, qpos
    # kq = N = 512: the NoCache step's and the prefill's shape
    mask512 = torch.ones((B, 1, N, N), dtype=torch.bool, device=dev)
    ms512 = median_ms(lambda: sa.sparse_attention(q, kc, vc, qpos), torch,
                      flush)
    sdpa512 = median_ms(lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask512), torch, flush)
    b512 = bound(2 * (2 * B * N * KVH * hd + 2 * B * N * H * hd) + 4 * B * N,
                 4 * B * N * N * H * hd)[0]
    print(f"  kq={N} (NoCache / prefill shape): kernel {ms512:.4f} ms, SDPA "
          f"{sdpa512:.4f} ms, bound {b512:.4f} ms")
    del mask512
    # hd=128 bf16 runs the main path's wgmma body; hd=64 and 120 the same
    # body at other widths; int8 K/V under bf16 q the int8 wgmma body
    # (check_int8_attention); every f32 case the three-pass TF32 body.
    edge = [
        dict(name="hd128 GQA ragged N window soft_cap kv_len", b=2, kq=50,
             n=300, h=8, kvh=2, hd=128, window=32, soft_cap=30.0,
             kv_len=[300, 170], quant=False),
        dict(name="hd64 GQA ragged N window soft_cap kv_len", b=2, kq=70,
             n=200, h=4, kvh=2, hd=64, window=40, soft_cap=20.0,
             kv_len=[131, 200], quant=False),
        dict(name="hd120 (padded to 128) GQA 32 on 8 window kv_len", b=2,
             kq=40, n=300, h=32, kvh=8, hd=120, window=32, soft_cap=0.0,
             kv_len=[300, 170], quant=False),
        dict(name="int8 K/V scales GQA", b=2, kq=24, n=160, h=4, kvh=2,
             hd=32, window=0, soft_cap=0.0, kv_len=None, quant=True),
        dict(name="kv_len 0 row (outputs 0)", b=2, kq=8, n=64, h=2, kvh=1,
             hd=128, window=0, soft_cap=0.0, kv_len=[64, 0], quant=False),
    ]
    for e in edge:
        for dt in (bf16, f32):
            qe = randn(e["b"], e["kq"], e["h"], e["hd"], dtype=dt)
            qp = randint(0, e["n"], e["b"], e["kq"])
            if e["quant"]:
                ke = randint(-127, 128, e["b"], e["n"], e["kvh"], e["hd"]
                             ).to(torch.int8)
                ve = randint(-127, 128, e["b"], e["n"], e["kvh"], e["hd"]
                             ).to(torch.int8)
                kse = (torch.rand((e["b"], e["n"], e["kvh"]), generator=gen,
                                  device=dev) * 0.02).to(torch.float16)
                vse = (torch.rand((e["b"], e["n"], e["kvh"]), generator=gen,
                                  device=dev) * 0.02).to(torch.float16)
            else:
                ke = randn(e["b"], e["n"], e["kvh"], e["hd"], dtype=dt)
                ve = randn(e["b"], e["n"], e["kvh"], e["hd"], dtype=dt)
                kse = vse = None
            kvl = (None if e["kv_len"] is None else torch.tensor(
                e["kv_len"], dtype=torch.int32, device=dev))
            kw = dict(k_scale=kse, v_scale=vse, window=e["window"],
                      soft_cap=e["soft_cap"], kv_len=kvl)
            a = sa.sparse_attention(qe, ke, ve, qp, **kw)
            bb = sa.sparse_attention_plain(qe, ke, ve, qp, **kw)
            tol = bf16_attn_tol if dt == bf16 else dict(atol=1e-5, rtol=0)
            assert_close(f"{e['name']} {dt}", a, bb, **tol)
    qt = q128.transpose(1, 2)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = torch.ones((B, 1, 128, N), dtype=torch.bool, device=dev)
    records["sparse_attention"] = dict(
        source="src/repro_torch/csrc/sparse_attention.cu",
        replaces="src/repro/kernels/sparse_attention.py:219",
        max_abs_err=err,
        ms=median_ms(lambda: sa.sparse_attention(q128, kc, vc, qpos128),
                     torch, flush),
        plain_ms=median_ms(lambda: sa.sparse_attention_plain(
            q128, kc, vc, qpos128), torch, flush),
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask), torch, flush),
        bound=bound(2 * (2 * B * N * KVH * hd + 2 * B * 128 * H * hd)
                    + 4 * B * 128, 4 * B * 128 * N * H * hd))
    print(f"  kq=128: kernel {records['sparse_attention']['ms']:.4f} ms, "
          f"SDPA {records['sparse_attention']['library_ms']:.4f} ms")
    print(f"  ptxas -v: {attention_ptxas()}")
    records.update(check_int8_attention(torch, flush, gen, randn, randint,
                                        assert_close))
    check_f32_attention(torch, flush, gen, randn, randint, assert_close)

    # -- scatter_update_multi -----------------------------------------------
    # a copy: results must be bit-identical.
    print("scatter_update_multi")

    def kv_bufs():
        return [randn(B, N, KVH, hd), randn(B, N, KVH, hd)]

    base = kv_bufs()
    for k in (16, 128):
        idx = torch.stack([torch.randperm(N, generator=gen, device=dev)[:k]
                           for _ in range(B)]).to(torch.int32)  # unsorted
        rows = [randn(B, k, KVH, hd), randn(B, k, KVH, hd)]
        got = [t.clone() for t in base]
        want = [t.clone() for t in base]
        sc.scatter_update_multi(got, idx, rows)
        sc.scatter_update_multi_plain(want, idx, rows)
        err = max(assert_close(f"k={k} K", got[0], want[0], 0, 0),
                  assert_close(f"k={k} V", got[1], want[1], 0, 0))
    # mixed buffers: int8 rows + f16 scales + f32 proxy, out-of-range drops
    idx_e = torch.tensor([[3, -1, 40, 2, 99, 7], [63, 0, 64, 5, 1, 200]],
                         dtype=torch.int32, device=dev)
    bufs = [randint(-127, 128, 2, 64, 2, 32).to(torch.int8),
            torch.rand((2, 64, 2), generator=gen, device=dev
                       ).to(torch.float16),
            randn(2, 64, 48, dtype=f32), randn(2, 64, 5)]
    rows_e = [randint(-127, 128, 2, 6, 2, 32).to(torch.int8),
              torch.rand((2, 6, 2), generator=gen, device=dev
                         ).to(torch.float16),
              randn(2, 6, 48, dtype=f32), randn(2, 6, 5)]
    got = [t.clone() for t in bufs]
    want = [t.clone() for t in bufs]
    sc.scatter_update_multi(got, idx_e, rows_e)
    sc.scatter_update_multi_plain(want, idx_e, rows_e)
    for t_got, t_want in zip(got, want):
        assert torch.equal(t_got, t_want), "mixed-buffer scatter differs"
    print("  mixed dtypes / widths / dropped indices: identical")
    k_bufs = [t.clone() for t in base]

    def index_copy_all():
        for buf, rw in zip(k_bufs, rows):
            flat = buf.view(B * N, KVH, hd)
            flat.index_copy_(0, (idx.long() + torch.arange(
                B, device=dev)[:, None] * N).reshape(-1),
                rw.reshape(B * k, KVH, hd))

    records["scatter_update_multi"] = dict(
        source="src/repro_torch/csrc/scatter_update.cu",
        replaces="src/repro/kernels/scatter_update.py:114", max_abs_err=err,
        ms=printed_ms("k=128 K+V kernel", lambda: sc.scatter_update_multi(
            k_bufs, idx, rows), torch, flush),
        plain_ms=median_ms(lambda: sc.scatter_update_multi_plain(
            k_bufs, idx, rows), torch, flush),
        library_ms=median_ms(index_copy_all, torch, flush),
        bound=bound(2 * 2 * (2 * B * 128 * KVH * hd) + 4 * B * 128, 0))
    check_row_movers(torch, flush)
    records.update(check_paged_kernels(torch, flush, gen, randn, randint,
                                       assert_close))
    records.update(check_drift_kernels(torch, flush, gen, randn,
                                       assert_close))
    records.update(check_hybrid_kernels(torch, flush, gen, randn, randint,
                                        assert_close))
    records.update(check_ssd_kernel(torch, flush, gen))
    check_nan_rows(torch, gen, randn, randint)
    for name, rec in records.items():
        lib = ("-" if rec["library_ms"] is None
               else f"{rec['library_ms']:.4f}")
        print(f"  {name}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]})")
    print(f"  f32 rows ({card_line()}):")
    for line in F32_ROWS:
        print(f"    {line}")
    _lib.reset_launch_counts()
    return records


# DeepSeek-67B's decode (B=4, prompt 256 + gen 256; 64 q heads on 8 kv
# heads of 128, int8 cache with f16 scales) and InternVL2-76B's canvas
# (1024 patches + prompt 256 + gen 256, the same heads)
INT8_ATTN = dict(B=4, N=512, H=64, KVH=8, hd=128, vlm_n=1536)
# the int8 K/V body's record reads its launches from phase 13's run of
INT8_CONFIG = "deepseek-67b"


def check_int8_attention(torch, flush, gen, randn, randint, assert_close):
    """Phase 3's int8 K/V attention under bf16 q (the int8 caches' path:
    ``attention_i8_wgmma``, counted as ``sparse_attention_int8``) against
    the plain version at 2^-7 of the largest output, with f16 scales as
    the cache holds them: head_dim 128 at GQA groups 6, 8 and 16, a window
    with a ragged kv_len and a 0 row, soft_cap, kq = 1 and a ragged kq,
    head_dim 64 and 120 (8-byte copies, padded to 128), the banded grid
    (bit for bit the dense grid, whose band covers the window).  Timed at
    DeepSeek-67B's shape (kq = 128 and kq = N = 512) and InternVL2-76B's
    N = 1536 (kq = 128), beside the bf16 body on bf16 K/V of the same
    shape and the plain version, and the f32-q body on the same int8 K/V
    (within 1e-5 of plain; a :func:`f32_row` each).
    Bound: int8 K/V, f16 scales, bf16 q and out and q_pos once each, and
    4 * B * kq * N * H * hd operations at the bf16 peak.  Returns the
    ``sparse_attention_int8`` record (DeepSeek-67B, kq = 128)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels import sparse_attention as sa

    dev = gen.device
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    tol = dict(atol=0, rtol=2 ** -7)

    def cache(b, n, kvh, hd):
        k, v = (randint(-127, 128, b, n, kvh, hd).to(torch.int8)
                for _ in range(2))
        ks, vs = ((torch.rand((b, n, kvh), generator=gen, device=dev)
                   * 0.02).to(f16) for _ in range(2))
        return k, v, ks, vs

    def positions(b, n, kq):
        if kq == n:
            return torch.arange(n, device=dev, dtype=torch.int32)[None] \
                .expand(b, n).contiguous()
        return torch.stack([torch.sort(torch.randperm(
            n, generator=gen, device=dev)[:kq]).values for _ in range(b)]
            ).to(torch.int32)

    def launched(fn):
        before = _lib.launch_counts()
        out = fn()
        after = _lib.launch_counts()
        assert after["sparse_attention_int8"] == \
            before["sparse_attention_int8"] + 1, "the int8 body did not run"
        assert all(after[k] == before[k] for k in ("sparse_attention",
                                                   "sparse_attention_banded"))
        return out

    print("sparse_attention, int8 K/V under bf16 q (attention_i8_wgmma)")
    edges = (
        ("hd128 G=6 window, ragged kv_len with a 0 row", 3, 300, 50, 12, 2,
         128, dict(window=32, kv_len=[300, 170, 0])),
        ("hd128 G=8 soft_cap", 2, 300, 37, 16, 2, 128,
         dict(soft_cap=30.0)),
        ("hd128 G=16 kq=1", 2, 300, 1, 16, 1, 128, {}),
        ("hd128 G=16 ragged kq=77 window soft_cap kv_len", 2, 513, 77, 16, 1,
         128, dict(window=64, soft_cap=20.0, kv_len=[513, 260])),
        ("hd64 G=2 window kv_len", 2, 200, 70, 4, 2, 64,
         dict(window=40, kv_len=[131, 200])),
        ("hd120 (padded to 128) 32 on 8 window kv_len", 2, 300, 40, 32, 8,
         120, dict(window=32, kv_len=[300, 170])),
    )
    for name, b, n, kq, h, kvh, hd, kw in edges:
        k, v, ks, vs = cache(b, n, kvh, hd)
        q, qp = randn(b, kq, h, hd), randint(0, n, b, kq)
        dead = [i for i, n_i in enumerate(kw.get("kv_len", ())) if n_i == 0]
        if "kv_len" in kw:
            kw = dict(kw, kv_len=torch.tensor(kw["kv_len"], dtype=torch.int32,
                                              device=dev))
        got = launched(lambda: sa.sparse_attention(
            q, k, v, qp, k_scale=ks, v_scale=vs, **kw))
        assert_close(name, got, sa.sparse_attention_plain(
            q, k, v, qp, k_scale=ks, v_scale=vs, **kw), **tol)
        assert not got[dead].any(), "a kv_len 0 row must output 0"
    # the banded grid, hd 128, G = 8: the last q block's 188 queries x 8
    # heads end in a partial tile
    b, n, kq = 2, 4100, 700
    k, v, ks, vs = cache(b, n, 2, 128)
    q = randn(b, kq, 16, 128)
    pos = torch.cat([torch.sort(randint(0, 1500, b, 512)).values,
                     torch.sort(randint(2000, 3000, b, kq - 512)).values],
                    dim=1)
    kw = dict(k_scale=ks, v_scale=vs, window=64, soft_cap=30.0,
              kv_len=torch.tensor([n, 2600], dtype=torch.int32, device=dev))
    got = launched(lambda: sa.sparse_attention(q, k, v, pos, banded=True,
                                               q_span=1500, **kw))
    assert_close(f"banded grid kq={kq} N={n} hd128 G=8", got,
                 sa.sparse_attention_plain(
                     q, k, v, pos, band=sa.band_for(pos, n, 64, 1500), **kw),
                 **tol)
    assert torch.equal(got, sa.sparse_attention(q, k, v, pos, **kw)), \
        "int8 banded grid differs from the dense grid"
    print("  banded grid: bit for bit equal to the dense grid")
    del k, v, q, got

    B, H, KVH, hd = (INT8_ATTN[x] for x in ("B", "H", "KVH", "hd"))
    record = None
    for label, n, kq in (("DeepSeek-67B kq=128", INT8_ATTN["N"], 128),
                         ("DeepSeek-67B kq=N=512", INT8_ATTN["N"],
                          INT8_ATTN["N"]),
                         ("InternVL2-76B N=1536 kq=128", INT8_ATTN["vlm_n"],
                          128)):
        k, v, ks, vs = cache(B, n, KVH, hd)
        q, pos = randn(B, kq, H, hd), positions(B, n, kq)
        kw = dict(k_scale=ks, v_scale=vs)
        err = assert_close(label, launched(lambda: sa.sparse_attention(
            q, k, v, pos, **kw)), sa.sparse_attention_plain(q, k, v, pos,
                                                             **kw), **tol)
        qf = q.float()
        assert_close(f"{label}, f32-q body", sa.sparse_attention(
            qf, k, v, pos, **kw), sa.sparse_attention_plain(qf, k, v, pos,
                                                            **kw), 1e-5, 0)
        kb = (k.float() * ks.float()[..., None]).to(bf16)
        vb = (v.float() * vs.float()[..., None]).to(bf16)
        ms = median_ms(lambda: sa.sparse_attention(q, k, v, pos, **kw),
                       torch, flush)
        bf16_ms = median_ms(lambda: sa.sparse_attention(q, kb, vb, pos),
                            torch, flush)
        f32q_ms = median_ms(lambda: sa.sparse_attention(qf, k, v, pos, **kw),
                            torch, flush, runs=10, warmup=1)
        plain_ms = median_ms(lambda: sa.sparse_attention_plain(
            q, k, v, pos, **kw), torch, flush, runs=10, warmup=1)
        f32q_plain = median_ms(lambda: sa.sparse_attention_plain(
            qf, k, v, pos, **kw), torch, flush, runs=10, warmup=1)
        bnd = bound(2 * B * n * KVH * hd + 2 * 2 * B * n * KVH
                    + 2 * 2 * B * kq * H * hd + 4 * B * kq,
                    4 * B * kq * n * H * hd)
        print(f"  {label}: int8 body {ms:.4f} ms, bf16 body on bf16 K/V "
              f"{bf16_ms:.4f} ms ({ms / bf16_ms:.2f}x), plain "
              f"{plain_ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}; "
              f"{bnd[0] / ms:.1%} of it)")
        f32_row(f"{label}, f32 q on int8 K/V", f32q_ms, f32q_plain, None,
                2 * B * n * KVH * hd + 2 * 2 * B * n * KVH
                + 2 * 4 * B * kq * H * hd + 4 * B * kq,
                4 * B * kq * n * H * hd)
        if record is None:
            record = dict(
                source="src/repro_torch/csrc/sparse_attention.cu",
                replaces="src/repro/kernels/sparse_attention.py:219",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                bound=bnd)
        del k, v, kb, vb, q, qf
    return {"sparse_attention_int8": record}


TF32_FLOPS = 495e12       # H100 SXM dense TF32 tensor-core peak
F32_ROWS = []             # phase 3's f32 rows, printed again at its end


def f32_row(label: str, ms: float, plain_ms: float, library_ms,
            nbytes: float, flops: float, library: str = "") -> None:
    """Print one of phase 3's f32 rows: the kernel's, its plain version's
    and (where one exists) a library call's median device ms beside its
    bound at the f32 CUDA-core peak (exact f32: bytes or 67 TFLOP/s) and
    the three-pass TF32 figure (3 x the operations at 495 TFLOP/s); kept
    in ``F32_ROWS``."""
    bnd = bound(nbytes, flops, F32_FLOPS)
    tf32 = 3 * flops / TF32_FLOPS * 1e3
    lib = "-" if library_ms is None else f"{library_ms:.4f} ms ({library})"
    line = (f"{label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
            f"{lib}, bound {bnd[0]:.4f} ms ({bnd[1]}, f32 CUDA cores; "
            f"{bnd[0] / ms:.1%} of it), three-pass TF32 {tf32:.4f} ms")
    F32_ROWS.append(line)
    print(f"  f32 row, {line}")


# phase 3's f32 attention rows: LLaDA-8B's heads in f32 (the reduced and
# trained models' path), and phase 8's f32 local layer (RecurrentGemma-9B:
# B=2, N=16384, 16 heads on one kv head of 256, window 2048, k = 2144)
F32_ATTN = dict(B=4, N=512, H=32, hd=128)
F32_LOCAL_KQ = 2144


def check_f32_attention(torch, flush, gen, randn, randint, assert_close):
    """Phase 3's f32 rows (``f32_row``): sparse_attention with f32 q and
    f32 K/V at LLaDA-8B's shape (kq = 128 and kq = N = 512; library: SDPA
    in f32 with a bool mask), the banded grid at phase 8's f32 local layer
    (hd 256, kq = 2144 stratified; bit for bit the dense grid; library:
    SDPA with the window mask) and proxy_score in f32 at the slice shape
    (library: ``torch.matmul`` of the projection alone), each within 1e-5
    of its plain version; and f32 edges: head_dim 36 and 256, GQA groups
    1 and 8, q, k and v one element off 16-byte alignment, f32 scales on
    f32 K/V.  TF32 is off for every library call (the matmul and cuDNN
    flags, asserted)."""
    import torch.nn.functional as F
    from repro_torch.core.spa_layer import q_span_bound
    from repro_torch.kernels import proxy_score as ps
    from repro_torch.kernels import sparse_attention as sa

    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    print("f32 rows (TF32 off: torch.backends.cuda.matmul.allow_tf32 = "
          "torch.backends.cudnn.allow_tf32 = False)")
    dev = gen.device
    f32 = torch.float32
    tol = dict(atol=1e-5, rtol=0)

    for name, b, n, kq, h, kvh, hd, kw, off in (
            ("hd36 G=8 window kv_len", 2, 200, 40, 16, 2, 36,
             dict(window=24, kv_len=[200, 77]), 0),
            ("hd256 G=1 soft_cap", 2, 300, 50, 4, 4, 256,
             dict(soft_cap=30.0), 0),
            ("hd128 G=8 unaligned q, k, v", 2, 300, 33, 16, 2, 128, {}, 1),
            ("hd120 G=4 f32 scales", 2, 150, 20, 8, 2, 120,
             dict(scales=True), 0)):
        def make(*shape):
            buf = randn(int(torch.tensor(shape).prod()) + off, dtype=f32)
            return buf[off:].view(*shape)
        q, k, v = make(b, kq, h, hd), make(b, n, kvh, hd), make(b, n, kvh, hd)
        qp = randint(0, n, b, kq)
        kw = dict(kw)
        if kw.pop("scales", False):
            kw["k_scale"], kw["v_scale"] = (
                torch.rand((b, n, kvh), generator=gen, device=dev) * 2
                for _ in range(2))
        if "kv_len" in kw:
            kw["kv_len"] = torch.tensor(kw["kv_len"], dtype=torch.int32,
                                        device=dev)
        assert_close(f"f32 {name}", sa.sparse_attention(q, k, v, qp, **kw),
                     sa.sparse_attention_plain(q, k, v, qp, **kw), **tol)

    B, N, H, hd = (F32_ATTN[x] for x in ("B", "N", "H", "hd"))
    k, v = randn(B, N, H, hd, dtype=f32), randn(B, N, H, hd, dtype=f32)
    for kq in (128, N):
        q = randn(B, kq, H, hd, dtype=f32)
        pos = (torch.arange(N, device=dev, dtype=torch.int32)[None]
               .expand(B, N).contiguous() if kq == N else torch.sort(
                   torch.randperm(N, generator=gen, device=dev)[:kq]
               ).values.to(torch.int32).expand(B, kq).contiguous())
        assert_close(f"LLaDA f32 kq={kq}", sa.sparse_attention(q, k, v, pos),
                     sa.sparse_attention_plain(q, k, v, pos), **tol)
        mask = torch.ones((B, 1, kq, N), dtype=torch.bool, device=dev)
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        f32_row(f"sparse_attention f32 q, f32 K/V, LLaDA-8B heads B={B} "
                f"N={N} kq={kq}",
                median_ms(lambda: sa.sparse_attention(q, k, v, pos), torch,
                          flush, runs=10, warmup=1),
                median_ms(lambda: sa.sparse_attention_plain(q, k, v, pos),
                          torch, flush, runs=10, warmup=1),
                median_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask), torch, flush, runs=10,
                    warmup=1),
                4 * (2 * B * N * H * hd + 2 * B * kq * H * hd) + 4 * B * kq,
                4 * B * kq * N * H * hd, "SDPA, bool mask")
        del q, qt, mask
    del k, v, kt, vt

    B, N, H, KVH, hd, W = (HYBRID[x] for x in ("B", "N", "H", "KVH", "hd",
                                               "window"))
    kq = F32_LOCAL_KQ
    span = q_span_bound(N, kq, 4)
    pos = _stratified_positions(torch, gen, B, N, kq, 4)
    band = sa.band_for(pos, N, W, span)
    assert band is not None, "phase 8's local layer runs the banded grid"
    k, v = randn(B, N, KVH, hd, dtype=f32), randn(B, N, KVH, hd, dtype=f32)
    q = randn(B, kq, H, hd, dtype=f32)
    got = sa.sparse_attention(q, k, v, pos, window=W, banded=True,
                              q_span=span)
    assert_close(f"banded f32 hd=256 kq={kq} n_band={band[1]}", got,
                 sa.sparse_attention_plain(q, k, v, pos, window=W,
                                           band=band), **tol)
    assert torch.equal(got, sa.sparse_attention(q, k, v, pos, window=W)), \
        "f32 banded grid differs from the dense grid"
    print("  banded f32 hd=256: bit for bit equal to the dense grid")
    del got
    kt = k.transpose(1, 2).expand(B, H, N, hd)
    vt = v.transpose(1, 2).expand(B, H, N, hd)
    wmask = ((pos[:, :, None].long()
              - torch.arange(N, device=dev)[None, None, :]).abs()
             <= W)[:, None]
    f32_row(f"sparse_attention f32 banded grid, phase 8's local layer B={B} "
            f"N={N} hd={hd} kq={kq} window {W}",
            median_ms(lambda: sa.sparse_attention(
                q, k, v, pos, window=W, banded=True, q_span=span), torch,
                flush, runs=5, warmup=1),
            median_ms(lambda: sa.sparse_attention_plain(
                q, k, v, pos, window=W, band=band), torch, flush, runs=3,
                warmup=1),
            median_ms(lambda: F.scaled_dot_product_attention(
                q.transpose(1, 2), kt, vt, attn_mask=wmask), torch, flush,
                runs=3, warmup=1),
            4 * (2 * B * N * KVH * hd + 2 * B * kq * H * hd) + 4 * B * kq,
            4 * H * hd * window_keys(torch, pos, N, W, band),
            "SDPA, window mask over all keys")
    del k, v, q, kt, vt, wmask

    B, N, d, r = (SLICE[x] for x in ("B", "N", "d", "r"))
    x, w, pc = (randn(B, N, d, dtype=f32), randn(d, r, scale=0.05, dtype=f32),
                randn(B, N, r, dtype=f32))
    s_k, p_k = ps.proxy_score(x, w, pc)
    s_p, p_p = ps.proxy_score_plain(x, w, pc)
    assert_close("proxy_score f32 slice scores", s_k, s_p, 1e-5, 0)
    assert_close("proxy_score f32 slice p_now", p_k, p_p, 0, 1e-5)
    f32_row(f"proxy_score f32 B={B} N={N} d={d} r={r}",
            median_ms(lambda: ps.proxy_score(x, w, pc), torch, flush),
            median_ms(lambda: ps.proxy_score_plain(x, w, pc), torch, flush),
            median_ms(lambda: torch.matmul(x, w), torch, flush),
            4 * (B * N * d + d * r + 2 * B * N * r) + 4 * B * N,
            2 * B * N * d * r, "torch.matmul, the projection alone")
    del x, w, pc


NAN_ROW = 1               # phase 3's NaN rows: the batch row whose cache
NAN_SPAN = (16, 32)       # holds NaN in these rows (one page of 16)


def check_nan_rows(torch, gen, randn, randint):
    """Phase 3's NaN rows: the kernels the engine's NaN guard relies on,
    at the slice shapes, with batch row ``NAN_ROW``'s cache rows
    ``NAN_SPAN`` set to NaN as a ``step_nan`` fault leaves them (K/V,
    int8 K/V scales, cached proxies, hidden states).  Each kernel's
    non-finite mask must equal its plain version's element for element,
    reach the output, and leave every other batch row bit-equal to a
    clean call of the kernel."""
    from repro_torch.kernels import proxy_score as ps
    from repro_torch.kernels import scatter_update as sc
    from repro_torch.kernels import sparse_attention as sa

    B, N, d, r = SLICE["B"], SLICE["N"], SLICE["d"], SLICE["r"]
    H, KVH, hd = SLICE["H"], SLICE["KVH"], SLICE["hd"]
    lo, hi = NAN_SPAN
    others = [b for b in range(B) if b != NAN_ROW]
    dev = gen.device

    def poison(t):
        t = t.clone()
        t[NAN_ROW, lo:hi] = float("nan")
        return t

    def check(name, kernel, plain, clean_args, bad_args):
        outs = (kernel(*bad_args), plain(*bad_args), kernel(*clean_args))
        if isinstance(outs[0], torch.Tensor):
            outs = tuple((o,) for o in outs)
        notes = []
        for got, want, clean in zip(*outs):
            bad = ~torch.isfinite(got)
            assert torch.equal(bad, ~torch.isfinite(want)), \
                f"{name}: non-finite masks differ in " \
                f"{int((bad != ~torch.isfinite(want)).sum())} elements"
            assert not bool(bad[others].any())
            assert torch.equal(got[others], clean[others]), \
                f"{name}: a clean row changed"
            notes.append(f"{int(bad.sum())}/{bad.numel()}")
        assert notes[0] != f"0/{outs[0][0].numel()}", \
            f"{name}: the NaN never reached the output"
        print(f"  NaN rows, {name}: non-finite {', '.join(notes)} as the "
              f"plain version's; other rows bit-equal to a clean call")

    qpos = torch.sort(torch.randperm(N, generator=gen, device=dev)[:128]
                      ).values.to(torch.int32).expand(B, 128).contiguous()
    q = randn(B, 128, H, hd)
    kc, vc = randn(B, N, KVH, hd), randn(B, N, KVH, hd)
    check("sparse_attention bf16 K/V", sa.sparse_attention,
          sa.sparse_attention_plain, (q, kc, vc, qpos),
          (q, poison(kc), poison(vc), qpos))
    k8 = randint(-127, 128, B, N, KVH, hd).to(torch.int8)
    v8 = randint(-127, 128, B, N, KVH, hd).to(torch.int8)
    ks = (torch.rand((B, N, KVH), generator=gen, device=dev) * 0.02
          ).to(torch.float16)
    vs = (torch.rand((B, N, KVH), generator=gen, device=dev) * 0.02
          ).to(torch.float16)

    def attn8(fn):
        return lambda q_, k_s, v_s: fn(q_, k8, v8, qpos, k_scale=k_s,
                                       v_scale=v_s)
    check("sparse_attention int8 K/V (NaN scales)",
          attn8(sa.sparse_attention), attn8(sa.sparse_attention_plain),
          (q, ks, vs), (q, poison(ks), poison(vs)))
    # f32 q (the TF32 body): f32 K/V, and int8 K/V with NaN scales
    qf, kf, vf = q.float(), kc.float(), vc.float()
    check("sparse_attention f32 q, f32 K/V", sa.sparse_attention,
          sa.sparse_attention_plain, (qf, kf, vf, qpos),
          (qf, poison(kf), poison(vf), qpos))
    check("sparse_attention f32 q, int8 K/V (NaN scales)",
          attn8(sa.sparse_attention), attn8(sa.sparse_attention_plain),
          (qf, ks, vs), (qf, poison(ks), poison(vs)))
    del qf, kf, vf
    x, w, pc = randn(B, N, d), randn(d, r, scale=0.05), randn(B, N, r)
    check("proxy_score (cached proxies)", ps.proxy_score,
          ps.proxy_score_plain, (x, w, pc), (x, w, poison(pc)))
    check("proxy_score (hidden states)", ps.proxy_score,
          ps.proxy_score_plain, (x, w, pc), (poison(x), w, pc))
    page = 16
    n_log = N // page
    pages = torch.randperm(B * n_log, generator=gen, device=dev) + 1
    pt = pages.view(B, n_log).to(torch.int32)
    arena = randn(B * n_log + 1, page, r)
    bad_arena = arena.clone()
    bad_arena[pt[NAN_ROW, lo // page:hi // page].long()] = float("nan")
    check("proxy_score_paged (a poisoned page)",
          lambda a: ps.proxy_score_paged(x, w, a, pt),
          lambda a: ps.proxy_score_paged_plain(x, w, a, pt),
          (arena,), (bad_arena,))
    assert torch.equal(sc.gather_pages(bad_arena[None], pt)[0].isnan(),
                       poison(sc.gather_pages(arena[None], pt)[0]).isnan())
    # f32 (the TF32 body)
    xf, wf, pcf = x.float(), w.float(), pc.float()
    check("proxy_score f32 (cached proxies)", ps.proxy_score,
          ps.proxy_score_plain, (xf, wf, pcf), (xf, wf, poison(pcf)))
    check("proxy_score f32 (hidden states)", ps.proxy_score,
          ps.proxy_score_plain, (xf, wf, pcf), (poison(xf), wf, pcf))
    check("proxy_score_paged f32 (a poisoned page)",
          lambda a: ps.proxy_score_paged(xf, wf, a, pt),
          lambda a: ps.proxy_score_paged_plain(xf, wf, a, pt),
          (arena.float(),), (bad_arena.float(),))
    del xf, wf, pcf
    xd = randn(B, N, r)
    check("cosine_drift (cached proxies)", ps.cosine_drift,
          ps.cosine_drift_plain, (xd, pc), (xd, poison(pc)))
    h = randn(B, N, d)
    wn = randn(d, scale=0.1)
    idx = torch.sort(torch.randperm(N, generator=gen, device=dev)[:128]
                     ).values
    idx[:4] = torch.tensor([lo, lo + 3, hi - 1, hi], device=dev)
    idx = torch.sort(idx).values.to(torch.int32).expand(B, 128).contiguous()
    check("gather_norm (hidden states)",
          lambda h_: ps.gather_norm(h_, idx, wn, 1e-6),
          lambda h_: ps.gather_norm_plain(h_, idx, wn, 1e-6),
          (h,), (poison(h),))


def row_movers_ptxas() -> str:
    """``-Xptxas -v`` of scatter_kernel and of each gather_norm_rows
    instance (element type, vector bytes, vectors a thread holds)."""
    found = ptxas_lines(r"(scatter_kernel|gather_norm_rowsI\w+?Li\d+ELi\d+E)")

    def name(key):
        m = re.match(r"gather_norm_rowsI(\w+?)Li(\d+)ELi(\d+)E", key)
        if m is None:
            return key
        t = "bf16" if "bfloat16" in m.group(1) else "f32"
        return f"gather_norm_rows<{t}, {m.group(2)} B, {m.group(3)}>"
    return "; ".join(f"{name(k)}: " + ", ".join(v)
                     for k, v in sorted(found.items()))


def check_row_movers(torch, flush):
    """scatter_update_multi and gather_norm at the shapes of the main
    paths beyond the slice case that their records time (k=128), each
    against its plain version, with its median time beside its bound
    (bytes: rows read once and written once; for gather_norm the raw and
    the normed rows written and w read once).

    scatter_update_multi (bit for bit, every case): LLaDA K+V (B=4, 32 kv
    heads of 128, bf16) at k=16, H + proxy (8 KB + 256 B rows),
    int8 K+V + f16 scales (4 KB + 64 B rows), int8 H + its 2-byte f16
    scale + proxy, and RecurrentGemma-9B's K+V (B=2, k=4096, one kv head
    of 256: 512-byte rows) and H + proxy (B=2, k=4096), with
    ``index_copy_`` per buffer beside each.  gather_norm (raw rows bit for
    bit, normed rows within 1e-2 of the largest: one bf16 ulp; f32 1e-5;
    two calls the same bits): LLaDA (B=4, N=512, d=4096, bf16) at k=16,
    the hybrid's B=2, N=16384 at k=4096 and 720, and f32, d=1000 and
    d=120 (clamped indices).  First the floor of the timing method: a
    one-element ``add_`` between the same events."""
    from repro_torch.kernels import proxy_score as ps
    from repro_torch.kernels import scatter_update as sc

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    bf16, f32, f16, i8 = (torch.bfloat16, torch.float32, torch.float16,
                          torch.int8)

    def rand(shape, dtype):
        if dtype == i8:
            return torch.randint(-127, 128, shape, generator=gen,
                                 device=dev, dtype=torch.int32).to(i8)
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def perm_idx(b, n, k, sort):
        rows = [torch.randperm(n, generator=gen, device=dev)[:k]
                for _ in range(b)]
        idx = torch.stack(rows)
        return (torch.sort(idx).values if sort else idx).to(torch.int32)

    one = torch.zeros(1, device=dev)
    print("timing floor")
    printed_ms("a one-element add_", lambda: one.add_(1), torch, flush)
    print("scatter_update_multi at every commit shape (kernel / plain / "
          "index_copy_ per buffer / bound)")
    S, Hy = SLICE, HYBRID
    kv = (S["KVH"], S["hd"])
    cases = [
        ("LLaDA K+V k=16", S["B"], S["N"], 16, [(kv, bf16), (kv, bf16)]),
        ("LLaDA H + proxy k=128", S["B"], S["N"], 128,
         [((S["d"],), bf16), ((S["r"],), bf16)]),
        ("int8 K+V + scales k=128", S["B"], S["N"], 128,
         [(kv, i8), (kv, i8), ((S["KVH"],), f16), ((S["KVH"],), f16)]),
        ("int8 H + 2-byte scale + proxy k=128", S["B"], S["N"], 128,
         [((S["d"],), i8), ((), f16), ((S["r"],), bf16)]),
        ("hybrid K+V k=4096", Hy["B"], Hy["N"], 4096,
         [((Hy["KVH"], Hy["hd"]), bf16), ((Hy["KVH"], Hy["hd"]), bf16)]),
        ("hybrid H + proxy k=4096", Hy["B"], Hy["N"], 4096,
         [((Hy["d"],), bf16), ((S["r"],), bf16)]),
    ]
    for name, b, n, k, bufs in cases:
        caches = [rand((b, n) + f, dt) for f, dt in bufs]
        rows = [rand((b, k) + f, dt) for f, dt in bufs]
        idx = perm_idx(b, n, k, sort=False)
        want = [c.clone() for c in caches]
        sc.scatter_update_multi_plain(want, idx, rows)
        got = [c.clone() for c in caches]
        sc.scatter_update_multi(got, idx, rows)
        for t_got, t_want in zip(got, want):
            assert torch.equal(t_got, t_want), f"{name} differs"
        del got, want
        moved = 2 * sum(r.numel() * r.element_size() for r in rows)

        def index_copy_all():
            for c, r in zip(caches, rows):
                flat = c.view((b * n,) + tuple(c.shape[2:]))
                flat.index_copy_(0, (idx.long() + torch.arange(
                    b, device=dev)[:, None] * n).reshape(-1),
                    r.reshape((b * k,) + tuple(r.shape[2:])))

        ms = median_ms(lambda: sc.scatter_update_multi(caches, idx, rows),
                       torch, flush)
        plain = median_ms(lambda: sc.scatter_update_multi_plain(
            caches, idx, rows), torch, flush, runs=10)
        lib = median_ms(index_copy_all, torch, flush, runs=10)
        bnd = bound(moved + 4 * b * k, 0)[0]
        print(f"  {name}: identical; kernel {ms:.4f} ms ({bnd / ms:.0%} of "
              f"bound), plain {plain:.4f} ms, index_copy_ {lib:.4f} ms, "
              f"bound {bnd:.4f} ms ({moved / 1e6:.2f} MB)")
        del caches, rows
    # dropped indices (-1, N, 2N) in an unsorted commit that mixes 16-byte,
    # 64-byte, 10-byte and 2-byte rows, k = 1 and k = 7
    n = 64
    for k in (1, 7):
        bufs = [((2, 32), i8), ((2,), f16), ((5,), bf16), ((), f16),
                ((48,), f32), ((4, 8), bf16)]
        caches = [rand((3, n) + f, dt) for f, dt in bufs]
        rows = [rand((3, k) + f, dt) for f, dt in bufs]
        idx = perm_idx(3, n, k, sort=False)
        idx[0, 0], idx[-1, -1] = -1, n
        if k > 2:
            idx[1, 1] = 2 * n
        want = [c.clone() for c in caches]
        sc.scatter_update_multi_plain(want, idx, rows)
        got = [c.clone() for c in caches]
        sc.scatter_update_multi(got, idx, rows)
        assert all(torch.equal(a, w) for a, w in zip(got, want)), \
            f"mixed commit k={k} differs"
    print("  mixed 16/64/10/2-byte rows, dropped -1, N, 2N, k=1 and 7: "
          "identical")

    print("gather_norm at every shape (kernel / plain / bound)")
    gcases = [("LLaDA k=16", S["B"], S["N"], S["d"], 16, bf16),
              ("hybrid k=4096", Hy["B"], Hy["N"], Hy["d"], 4096, bf16),
              ("hybrid k=720", Hy["B"], Hy["N"], Hy["d"], 720, bf16),
              ("LLaDA f32 k=128", S["B"], S["N"], S["d"], 128, f32)]
    for name, b, n, d, k, dt in gcases:
        h = rand((b, n, d), dt)
        w = (torch.randn(d, generator=gen, device=dev) * 0.1).to(dt)
        idx = perm_idx(b, n, k, sort=True)
        rk, nk = ps.gather_norm(h, idx, w, 1e-6)
        rp, np_ = ps.gather_norm_plain(h, idx, w, 1e-6)
        assert torch.equal(rk, rp), f"gather_norm {name}: raw rows differ"
        err = max_err(nk, np_)
        lim = (1e-2 if dt == bf16 else 1e-5) * float(np_.float().abs().max())
        assert err <= lim, f"gather_norm {name}: {err} > {lim}"
        r2, n2 = ps.gather_norm(h, idx, w, 1e-6)
        assert torch.equal(n2, nk) and torch.equal(r2, rk), \
            f"gather_norm {name}: two calls differ"
        ms = median_ms(lambda: ps.gather_norm(h, idx, w, 1e-6), torch, flush)
        plain = median_ms(lambda: ps.gather_norm_plain(h, idx, w, 1e-6),
                          torch, flush, runs=10)
        es = h.element_size()
        moved = 3 * b * k * d * es + d * es
        bnd = bound(moved + 4 * b * k, 0)[0]
        print(f"  {name}: rows identical, normed max_abs_err {err:.3e} "
              f"(limit {lim:.3e}); kernel {ms:.4f} ms ({bnd / ms:.0%} of "
              f"bound), plain {plain:.4f} ms, bound {bnd:.4f} ms "
              f"({moved / 1e6:.2f} MB)")
        del h, rk, nk, rp, np_, r2, n2
    idx = torch.tensor([[5, -3, 700, 2, 511, 0, 9000, 7]] * 2,
                       dtype=torch.int32, device=dev)
    for d in (1000, 120):
        for dt in (bf16, f32):
            h = rand((2, 512, d), dt)
            w = (torch.randn(d, generator=gen, device=dev) * 0.1).to(dt)
            (rk, nk), (rp, np_) = (ps.gather_norm(h, idx, w, 1e-6),
                                   ps.gather_norm_plain(h, idx, w, 1e-6))
            assert torch.equal(rk, rp), f"gather_norm d={d} {dt}: raw rows"
            lim = (1e-2 if dt == bf16 else 1e-5) * float(
                np_.float().abs().max())
            assert max_err(nk, np_) <= lim, f"gather_norm d={d} {dt}"
    print("  d=1000 and d=120, bf16 and f32, clamped indices: rows "
          "identical, normed within the limit")
    print(f"  ptxas -v: {row_movers_ptxas()}")


def check_paged_kernels(torch, flush, gen, randn, randint, assert_close):
    """gather_pages, scatter_pages, scatter_rows_paged and
    proxy_score_paged against their plain versions at the serving slice
    (LLaDA-8B: 32 layers, B=4, N=512, page 16, bf16; a pool of 129 pages
    so that every logical page of the 4 rows is a real one) and at edge
    cases (zero page, sentinel N, idx < 0, logical pages past n_log, short
    rows, int8 K/V and f16 scales); scatter_rows_paged also at 256-byte,
    8 KB, 10-byte and 2-byte rows and k in {1, 16, 128, 511, 4096}.  The
    copies must be exact, and proxy_score_paged bitwise equal to
    proxy_score on the gathered pages."""
    from repro_torch.kernels import proxy_score as ps
    from repro_torch.kernels import scatter_update as sc

    dev = torch.device("cuda")
    B, N, d, r = SLICE["B"], SLICE["N"], SLICE["d"], SLICE["r"]
    L, F, page = 32, SLICE["KVH"] * SLICE["hd"], PAGE
    n_log = N // page
    P = 1 + B * n_log
    records = {}

    def exact(name, got, want):
        assert torch.equal(got, want), f"{name}: differs from plain"
        print(f"  {name}: identical")
        return 0.0

    # every logical page real (a permutation of the pool's 128 pages), and
    # a table of short rows whose tails map to the zero page
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    pt = perm.reshape(B, n_log).to(torch.int32).contiguous()
    pt_short = pt.clone()
    for b_, n_real in enumerate((32, 16, 24, 8)):
        pt_short[b_, n_real:] = 0

    # -- gather_pages / scatter_pages (one buffer: K, V or H) ----------------
    print("gather_pages / scatter_pages")
    arena = randn(L, P, page, F)
    arena[:, 0] = 0
    for name, table in (("full rows", pt), ("short rows", pt_short)):
        exact(f"gather {name}", sc.gather_pages(arena, table),
              sc.gather_pages_plain(arena, table))
    dense = randn(L, B, N, F)
    for name, table in (("full rows", pt), ("short rows", pt_short)):
        got, want = arena.clone(), arena.clone()
        sc.scatter_pages(got, table, dense)
        sc.scatter_pages_plain(want, table, dense)
        exact(f"scatter {name}", got, want)
        assert not got[:, 0].any(), "scatter_pages wrote the zero page"
        del got, want
    # the int8 cache's buffers: int8 K/V rows, f16 scales of width 32 and 1
    for shape, dt in (((2, 128), torch.int8), ((32,), torch.float16),
                      ((), torch.float16)):
        small = (randint(-127, 128, 2, 9, page, *shape).to(dt)
                 if dt == torch.int8 else randn(2, 9, page, *shape, dtype=dt))
        small[:, 0] = 0
        tbl = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 8]], dtype=torch.int32,
                           device=dev)
        exact(f"gather {dt} {shape}", sc.gather_pages(small, tbl),
              sc.gather_pages_plain(small, tbl))
        dn = (randint(-127, 128, 2, 2, 4 * page, *shape).to(dt)
              if dt == torch.int8 else randn(2, 2, 4 * page, *shape,
                                             dtype=dt))
        got, want = small.clone(), small.clone()
        sc.scatter_pages(got, tbl, dn)
        sc.scatter_pages_plain(want, tbl, dn)
        exact(f"scatter {dt} {shape}", got, want)
    pt_long = pt.long()
    side_bytes = 2 * L * B * N * F          # one side of the copy, bf16
    records["gather_pages"] = dict(
        source="src/repro_torch/csrc/paged.cu",
        replaces="src/repro/kernels/scatter_update.py:160", max_abs_err=0.0,
        ms=median_ms(lambda: sc.gather_pages(arena, pt), torch, flush),
        plain_ms=median_ms(lambda: sc.gather_pages_plain(arena, pt), torch,
                           flush),
        library_ms=median_ms(lambda: arena[:, pt_long], torch, flush),
        bound=bound(2 * side_bytes + 4 * B * n_log, 0))
    back = arena.clone()
    # the library call: one index_put_ of the whole view (the full-row table
    # maps no logical page to the zero page, so nothing is to be dropped)
    dense_pages = dense.view(L, B, n_log, page, F)
    library = back.clone()
    library[:, pt_long] = dense_pages
    sc.scatter_pages(back, pt, dense)
    exact("scatter library index_put_", back, library)
    del library

    def put():
        back[:, pt_long] = dense_pages

    records["scatter_pages"] = dict(
        source="src/repro_torch/csrc/paged.cu",
        replaces="src/repro/kernels/scatter_update.py:199", max_abs_err=0.0,
        ms=median_ms(lambda: sc.scatter_pages(back, pt, dense), torch, flush),
        plain_ms=median_ms(lambda: sc.scatter_pages_plain(back, pt, dense),
                           torch, flush),
        library_ms=median_ms(put, torch, flush),
        bound=bound(2 * side_bytes + 4 * B * n_log, 0))
    del arena, dense, back

    # -- scatter_rows_paged (one layer of the proxy arena) -------------------
    print("scatter_rows_paged")
    parena = randn(L, P, page, r)
    parena[:, 0] = 0
    lay = L // 2                             # the layer slice written
    k = 128
    idx = torch.sort(torch.stack([
        torch.randperm(N, generator=gen, device=dev)[:k]
        for _ in range(B)])).values
    idx = idx.to(torch.int32).contiguous()
    rows = randn(B, k, r)
    idx_e = idx.clone()
    idx_e[:, -4:] = N                        # the top-k sentinel
    idx_e[0, 0], idx_e[1, 0] = -1, N + 40    # idx < 0, page >= n_log
    for name, table, ii in (("k=128", pt, idx), ("drops", pt_short, idx_e)):
        got, want = parena.clone(), parena.clone()
        sc.scatter_rows_paged(got[lay], table, ii, rows)
        sc.scatter_rows_paged_plain(want[lay], table, ii, rows)
        exact(f"{name}", got, want)
        assert not got[:, 0].any(), "scatter_rows_paged wrote the zero page"
    for shape, dt in (((2, 128), torch.int8), ((32,), torch.float16),
                      ((), torch.float16)):
        small = torch.zeros((3, 9, page) + shape, dtype=dt, device=dev)
        rw = (randint(-127, 128, 2, 6, *shape).to(dt) if dt == torch.int8
              else randn(2, 6, *shape, dtype=dt))
        tbl = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 8]], dtype=torch.int32,
                           device=dev)
        ii = torch.tensor([[0, 5, 40, -2, 64, 17], [1, 20, 33, 62, 63, 3]],
                          dtype=torch.int32, device=dev)
        got, want = small.clone(), small.clone()
        sc.scatter_rows_paged(got[1], tbl, ii, rw)
        sc.scatter_rows_paged_plain(want[1], tbl, ii, rw)
        exact(f"{dt} {shape}", got, want)
    # the row widths of the port's commits (256-byte r=128 and 8 KB r=4096
    # bf16 proxy rows, 10-byte int8 and 2-byte f16 rows) at k in {1, 16,
    # 128, 4096}, unsorted, with every drop rule, into one layer of a
    # two-layer arena: B=4, N=512, pages of 16; k=4096 on the hybrid's
    # canvas (B=2, N=16384); B=5, k=511 makes runs of two rows that
    # straddle batch rows
    for shape, dt in (((r,), torch.bfloat16), ((d,), torch.bfloat16),
                      ((10,), torch.int8), ((), torch.float16)):
        for b_, n_, k_ in ((B, N, 1), (B, N, 16), (B, N, 128), (5, N, 511),
                           (2, HYBRID["N"], 4096)):
            nl = n_ // page
            pool = 1 + b_ * nl
            tbl = (torch.randperm(pool - 1, generator=gen, device=dev) + 1
                   ).reshape(b_, nl).to(torch.int32)
            tbl[1, nl // 2:] = 0                  # a short row
            ii = torch.stack([torch.randperm(n_, generator=gen,
                                             device=dev)[:k_]
                              for _ in range(b_)]).to(torch.int32)
            if k_ > 1:
                ii[0, 0], ii[1, -1] = -1, n_      # idx < 0, the sentinel
            if dt == torch.int8:
                ar = randint(-127, 128, 2, pool, page, *shape).to(dt)
                rw = randint(-127, 128, b_, k_, *shape).to(dt)
            else:
                ar = randn(2, pool, page, *shape, dtype=dt)
                rw = randn(b_, k_, *shape, dtype=dt)
            ar[:, 0] = 0
            got, want = ar.clone(), ar.clone()
            sc.scatter_rows_paged(got[1], tbl, ii, rw)
            sc.scatter_rows_paged_plain(want[1], tbl, ii, rw)
            assert torch.equal(got, want), \
                f"scatter_rows_paged {dt} {shape} k={k_}: differs from plain"
            assert not got[:, 0].any(), \
                "scatter_rows_paged wrote the zero page"
            if shape == (d,) and k_ == k:
                # the attn_in lane's commit: 8 KB proxy rows
                ms8 = median_ms(lambda: sc.scatter_rows_paged(
                    got[1], tbl, ii, rw), torch, flush)
                b8 = bound(2 * 2 * b_ * k_ * d + 4 * b_ * (k_ + nl), 0)[0]
            if shape == (r,) and k_ == 4096:
                # 256-byte rows, 8192 of them: runs of several rows a warp
                ms4k = median_ms(lambda: sc.scatter_rows_paged(
                    got[1], tbl, ii, rw), torch, flush)
                b4k = bound(2 * 2 * b_ * k_ * r + 4 * b_ * (k_ + nl), 0)[0]
            del ar, rw, got, want
    print("  256-byte, 8 KB, 10-byte and 2-byte rows at k=1, 16, 128, "
          "511 (B=5), 4096: identical")
    print(f"  8 KB rows (r=4096) k={k}: kernel {ms8:.4f} ms, bound "
          f"{b8:.4f} ms")
    print(f"  256-byte rows k=4096 (B=2, N={HYBRID['N']}): kernel "
          f"{ms4k:.4f} ms, bound {b4k:.4f} ms")
    work = parena.clone()
    records["scatter_rows_paged"] = dict(
        source="src/repro_torch/csrc/paged.cu",
        replaces="src/repro/kernels/scatter_update.py:296", max_abs_err=0.0,
        ms=printed_ms("k=128 kernel", lambda: sc.scatter_rows_paged(
            work[lay], pt, idx, rows), torch, flush),
        plain_ms=median_ms(lambda: sc.scatter_rows_paged_plain(
            work[lay], pt, idx, rows), torch, flush),
        library_ms=None,
        bound=bound(2 * 2 * B * k * r + 4 * B * k + 4 * B * n_log, 0))

    # -- proxy_score_paged ---------------------------------------------------
    # bitwise equal to proxy_score on the gathered pages: both run one
    # kernel body that differs only in how a p_cached row is addressed.
    print("proxy_score_paged")
    x = randn(B, N, d)
    w = randn(d, r, scale=0.05)
    err = 0.0
    for name, table in (("full rows", pt), ("short rows", pt_short)):
        s_k, p_k = ps.proxy_score_paged(x, w, parena[lay], table)
        s_d, p_d = ps.proxy_score(
            x, w, sc.gather_pages(parena[lay][None], table)[0])
        assert torch.equal(s_k, s_d) and torch.equal(p_k, p_d), \
            f"proxy_score_paged {name}: not bitwise proxy_score"
        print(f"  {name}: bitwise equal to proxy_score on the gathered pages")
        s_p, p_p = ps.proxy_score_paged_plain(x, w, parena[lay], table)
        err = max(err, assert_close(f"{name} scores vs plain", s_k, s_p,
                                    5e-3, 0))
        assert_close(f"{name} p_now vs plain", p_k, p_p, 0, 1e-2)
    xf, wf, af = x[:2, :80].float(), w.float(), parena[lay].float()
    tf = torch.tensor([[1, 7, 0, 0, 0], [9, 2, 3, 4, 100]],
                      dtype=torch.int32, device=dev)
    s_k, p_k = ps.proxy_score_paged(xf, wf, af, tf)
    s_d, p_d = ps.proxy_score(xf, wf, sc.gather_pages(af[None], tf)[0])
    assert torch.equal(s_k, s_d) and torch.equal(p_k, p_d), \
        "f32 proxy_score_paged: not bitwise proxy_score"
    print("  f32 N=80: bitwise equal to proxy_score on the gathered pages")
    records["proxy_score_paged"] = dict(
        source="src/repro_torch/csrc/proxy_score.cu",
        replaces="src/repro/kernels/proxy_score.py:207", max_abs_err=err,
        ms=median_ms(lambda: ps.proxy_score_paged(x, w, parena[lay], pt),
                     torch, flush),
        plain_ms=median_ms(lambda: ps.proxy_score_paged_plain(
            x, w, parena[lay], pt), torch, flush),
        library_ms=None,
        bound=bound(2 * (B * N * d + d * r + 2 * B * N * r) + 4 * B * N
                    + 4 * B * n_log, 2 * B * N * d * r))
    return records


def check_drift_kernels(torch, flush, gen, randn, assert_close):
    """cosine_drift, cosine_drift_paged and the wide-rank proxy_score
    against their plain versions.  cosine_drift at B=4, N=512 and N=509
    for r in {8, 64, 96, 128, 4096} and every pairing of f32 and bf16
    operands (timed at the attn_in / attn_out width, r=4096 bf16 both, and
    at the incremental identifier's, f32 x against a bf16 cache at r=128);
    cosine_drift_paged bitwise equal to cosine_drift on the gathered pages
    for the same cases; proxy_score and proxy_score_paged at r=4096
    (the value identifier, bf16), paged bitwise dense.  Tolerances:
    cosine_drift sums in f32 like its plain version, in another order,
    so 1e-5; wide proxy_score as proxy_score (p within one bf16 ulp, 2^-7
    relative; scores 5e-3)."""
    import torch.nn.functional as F
    from repro_torch.kernels import proxy_score as ps
    from repro_torch.kernels import scatter_update as sc

    dev = torch.device("cuda")
    B, N, d = SLICE["B"], SLICE["N"], SLICE["d"]
    bf16, f32 = torch.bfloat16, torch.float32
    page, n_log = PAGE, SLICE["N"] // PAGE
    records = {}

    print("cosine_drift")
    P = 1 + B * n_log
    perm = torch.randperm(P - 1, generator=gen, device=dev) + 1
    pt = perm.reshape(B, n_log).to(torch.int32).contiguous()
    pt_short = pt.clone()
    for b_, n_real in enumerate((32, 16, 24, 8)):
        pt_short[b_, n_real:] = 0
    # every rank the identifiers score at (8 ... 4096) and every pairing of
    # f32 and bf16 operands, at the slice's B and N and a ragged N; unchanged
    # rows score 1, an all-zero row 0 (the eps floor), two calls the same
    # bits, and the paged instance bitwise the dense one on the gathered
    # pages (every page real, and short rows over the zero page)
    err = err_paged = 0.0
    for r_ in (8, 64, 96, 128, d):
        for xd in (f32, bf16):
            for cd in (f32, bf16):
                xe = randn(B, N, r_, dtype=xd)
                pe = randn(B, N, r_, dtype=cd)
                pe[:, :8] = xe[:, :8].to(cd)
                xe[1, 9] = 0
                tag = f"{str(xd)[6:]}/{str(cd)[6:]} r={r_}"
                for n_ in (N, N - 3):
                    xs = xe[:, :n_].contiguous()
                    ps_ = pe[:, :n_].contiguous()
                    s_k = ps.cosine_drift(xs, ps_)
                    e = max_err(s_k, ps.cosine_drift_plain(xs, ps_))
                    assert e <= 1e-5, f"cosine_drift {tag} N={n_}: {e}"
                    assert torch.equal(s_k, ps.cosine_drift(xs, ps_)), \
                        f"cosine_drift {tag}: two calls differ"
                    if (xd, cd, r_) == (bf16, bf16, d):
                        err = max(err, e)
                if xd == cd:
                    assert float((s_k[:, :8] - 1).abs().max()) < 1e-5, \
                        f"cosine_drift {tag}: unchanged rows must score 1"
                assert float(s_k[1, 9]) == 0.0, f"{tag}: zero row"
                ar = randn(P, page, r_, dtype=cd)
                ar[0] = 0
                for table in (pt, pt_short):
                    s_pg = ps.cosine_drift_paged(xe, ar, table)
                    s_d = ps.cosine_drift(
                        xe, sc.gather_pages(ar[None], table)[0])
                    assert torch.equal(s_pg, s_d), \
                        f"cosine_drift_paged {tag}: not bitwise cosine_drift"
                    assert torch.equal(
                        s_pg, ps.cosine_drift_paged(xe, ar, table)), \
                        f"cosine_drift_paged {tag}: two calls differ"
                    e = max_err(s_pg,
                                ps.cosine_drift_paged_plain(xe, ar, table))
                    assert e <= 1e-5, f"cosine_drift_paged {tag}: {e}"
                    if (xd, cd, r_) == (bf16, bf16, d):
                        err_paged = max(err_paged, e)
                print(f"  {tag}: within 1e-5 of plain (N={N} and {N - 3}), "
                      f"unchanged rows 1, two calls the same bits, paged "
                      f"bitwise dense (full and short rows)")
                del xe, pe, ar
    x = randn(B, N, d)
    pc = randn(B, N, d)
    r_inc = SLICE["r"]
    x_inc = randn(B, N, r_inc, dtype=f32)
    pc_inc = randn(B, N, r_inc)
    inc_ms = printed_ms("f32/bf16 r=128 (incremental width) kernel",
                        lambda: ps.cosine_drift(x_inc, pc_inc), torch, flush)
    inc_bound = bound(4 * B * N * r_inc + 2 * B * N * r_inc + 4 * B * N,
                      6 * B * N * r_inc, F32_FLOPS)
    print(f"  f32/bf16 r=128: kernel {inc_ms:.4f} ms, bound "
          f"{inc_bound[0]:.4f} ms ({inc_bound[1]})")
    records["cosine_drift"] = dict(
        source="src/repro_torch/csrc/proxy_score.cu",
        replaces="src/repro/kernels/proxy_score.py:138", max_abs_err=err,
        ms=printed_ms("bf16/bf16 r=4096 kernel", lambda: ps.cosine_drift(
            x, pc), torch, flush),
        plain_ms=median_ms(lambda: ps.cosine_drift_plain(x, pc), torch,
                           flush),
        library_ms=median_ms(lambda: F.cosine_similarity(x, pc, dim=-1),
                             torch, flush),
        bound=bound(2 * 2 * B * N * d + 4 * B * N, 6 * B * N * d,
                    F32_FLOPS))

    print("cosine_drift_paged")
    arena = randn(P, page, d)
    arena[0] = 0
    arena_inc = randn(P, page, r_inc)
    inc_ms = printed_ms(
        "f32/bf16 r=128 kernel", lambda: ps.cosine_drift_paged(
            x_inc, arena_inc, pt), torch, flush)
    print(f"  f32/bf16 r=128: kernel {inc_ms:.4f} ms, bound "
          f"{inc_bound[0]:.4f} ms ({inc_bound[1]})")
    records["cosine_drift_paged"] = dict(
        source="src/repro_torch/csrc/proxy_score.cu",
        replaces="src/repro/kernels/proxy_score.py:254", max_abs_err=err_paged,
        ms=printed_ms("bf16 r=4096 kernel", lambda: ps.cosine_drift_paged(
            x, arena, pt), torch, flush),
        plain_ms=median_ms(lambda: ps.cosine_drift_paged_plain(
            x, arena, pt), torch, flush),
        library_ms=None,
        bound=bound(2 * 2 * B * N * d + 4 * B * N + 4 * B * n_log,
                    6 * B * N * d, F32_FLOPS))
    # back to back, operands L2-hot (the clean flush's times are above)
    for tag, fn in (
            ("bf16 r=4096", lambda: ps.cosine_drift(x, pc)),
            ("paged bf16 r=4096", lambda: ps.cosine_drift_paged(
                x, arena, pt)),
            ("f32/bf16 r=128", lambda: ps.cosine_drift(x_inc, pc_inc)),
            ("paged f32/bf16 r=128", lambda: ps.cosine_drift_paged(
                x_inc, arena_inc, pt))):
        us, n = warm_us(fn, torch, "cosine_drift_kernel")
        print(f"  {tag}: warm " + ("not measured" if us is None else
                                   f"{us:.3f} us a call")
              + f" ({n} of 200 back-to-back calls traced, L2-hot)")
    del x_inc, pc_inc, arena_inc

    print("proxy_score at r=4096 (projection kernel + cosine_drift)")
    r_w = d                                   # kv_dim of LLaDA-8B
    w = randn(d, r_w, scale=0.02)
    pcw = randn(B, N, r_w)
    s_k, p_k = ps.proxy_score(x, w, pcw)
    s_p, p_p = ps.proxy_score_plain(x, w, pcw)
    err = max(assert_close("r=4096 scores", s_k, s_p, 5e-3, 0),
              assert_close("r=4096 p_now", p_k, p_p, 0, 1e-2))
    s1, _ = ps.proxy_score(x, w, p_k)
    assert float((s1 - 1).abs().max()) < 1e-5, "unchanged rows must score 1"
    xe, we = randn(2, 70, 256), randn(256, 272, scale=0.1)
    pe = randn(2, 70, 272)
    a, bb = ps.proxy_score(xe, we, pe), ps.proxy_score_plain(xe, we, pe)
    assert_close("bf16 N=70 d=256 r=272 scores", a[0], bb[0], 5e-3, 0)
    xf, wf, pf = xe.float(), we.float(), pe.float()
    a, bb = ps.proxy_score(xf, wf, pf), ps.proxy_score_plain(xf, wf, pf)
    assert_close("f32 N=70 d=256 r=272 scores", a[0], bb[0], 1e-5, 0)
    assert_close("f32 N=70 d=256 r=272 p_now", a[1], bb[1], 0, 1e-5)
    arena_w = randn(P, page, r_w)
    arena_w[0] = 0
    for name, table in (("full rows", pt), ("short rows", pt_short)):
        s_pg, p_pg = ps.proxy_score_paged(x, w, arena_w, table)
        s_d, p_d = ps.proxy_score(
            x, w, sc.gather_pages(arena_w[None], table)[0])
        assert torch.equal(s_pg, s_d) and torch.equal(p_pg, p_d), \
            f"wide proxy_score_paged {name}: not bitwise proxy_score"
        print(f"  paged {name}: bitwise equal to proxy_score on the "
              f"gathered pages")
    records["proxy_score_wide"] = dict(
        source="src/repro_torch/csrc/proxy_score.cu",
        replaces="src/repro/kernels/proxy_score.py:101", max_abs_err=err,
        ms=median_ms(lambda: ps.proxy_score(x, w, pcw), torch, flush),
        plain_ms=median_ms(lambda: ps.proxy_score_plain(x, w, pcw), torch,
                           flush),
        library_ms=None,
        bound=bound(2 * (B * N * d + d * r_w + 2 * B * N * r_w) + 4 * B * N,
                    2 * B * N * d * r_w))
    # the projection alone (the store epilogue) beside one torch.matmul
    # of the same product: no PyTorch call computes proxy_score itself
    proj_ms = median_ms(lambda: ps._project_wide(x, w), torch, flush)
    mm_ms = median_ms(lambda: torch.matmul(x, w), torch, flush)
    proj_b = bound(2 * (B * N * d + d * r_w + B * N * r_w),
                   2 * B * N * d * r_w)
    print(f"  r=4096 projection alone: kernel {proj_ms:.4f} ms, "
          f"torch.matmul {mm_ms:.4f} ms, bound {proj_b[0]:.4f} ms "
          f"({proj_b[1]}); {2 * B * N * d * r_w / proj_ms / 1e9:.1f} TFLOP/s")
    del x, pc, arena, arena_w, w, pcw
    return records


def _stratified_positions(torch, gen, b: int, n: int, k: int, nb: int):
    """Sorted positions like ``select_stratified``'s: k // nb random rows
    in each of nb equal strata, per batch row."""
    dev = torch.device("cuda")
    size, per = n // nb, k // nb
    rows = []
    for _ in range(b):
        rows.append(torch.cat([
            torch.sort(torch.randperm(size, generator=gen, device=dev)[:per]
                       ).values + j * size for j in range(nb)]))
    return torch.stack(rows).to(torch.int32).contiguous()


def window_keys(torch, pos, n: int, window: int, band=None) -> int:
    """The keys the attention needs, summed over all queries of pos [B, kq]:
    for each query those within its window of the n keys, and within its
    q block's band on the banded grid (band from ``band_for``)."""
    p = pos.long()
    lo, hi = (p - window).clamp(min=0), (p + window).clamp(max=n - 1)
    if band is not None:
        starts, n_band, bq = band
        bk = min(512, n)
        st = starts.long().repeat_interleave(bq)[:p.shape[1]][None] * bk
        lo = torch.maximum(lo, st)
        hi = torch.minimum(hi, (st + n_band * bk).clamp(max=n) - 1)
    return int((hi - lo + 1).clamp(min=0).sum())


def check_hybrid_kernels(torch, flush, gen, randn, randint, assert_close):
    """The banded sparse_attention grid, the bf16 tensor-core attention at
    head_dim 256 and rglru_scan, at RecurrentGemma-9B's decode shapes (B=2,
    N=16384, 16 query heads on one kv head of 256, window 2048; a, b of the
    recurrence [2, 16384, 4096]) and at edges.

    Banded: decode (kq = 4096 stratified rows, q_span 8192, 26 kv blocks a
    q block) and prefill (kq = N contiguous, 11 blocks) in bf16 against the
    plain banded version (2^-7 of the largest output, as the dense grid),
    and bit for bit equal to the dense grid on the same inputs, since the
    band covers the window; f32 and int8 K/V at a ragged kq and N (f32
    1e-5).  The dense grid at head_dim 256 in bf16 (kq = 1744, the widest
    dense-grid layer) against plain.  rglru_scan (one pass with a decoupled
    look-back) in bf16 (one bf16 ulp of each element) and f32 (1e-5: the
    chunk carries reassociate), forward and flipped, and at a ragged T and
    d (the plain-copy path), with its kernel's ``-Xptxas -v`` lines."""
    import torch.nn.functional as F
    from repro_torch.core.spa_layer import q_span_bound
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import sparse_attention as sa

    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    B, N, H, KVH, hd, W = (HYBRID[k] for k in ("B", "N", "H", "KVH", "hd",
                                               "window"))
    records = {}
    bf16_attn_tol = dict(atol=0, rtol=2 ** -7)

    print("sparse_attention, banded grid (RecurrentGemma-9B shapes)")
    k = randn(B, N, KVH, hd)
    v = randn(B, N, KVH, hd)
    kq = 4096
    span = q_span_bound(N, kq, 4)
    pos = _stratified_positions(torch, gen, B, N, kq, 4)
    q = randn(B, kq, H, hd)
    assert sa.banded_engages(N, W, True, span)
    band = sa.band_for(pos, N, W, span)
    got = sa.sparse_attention(q, k, v, pos, window=W, banded=True,
                              q_span=span)
    err = assert_close(f"decode kq={kq} q_span={span} n_band={band[1]}",
                       got, sa.sparse_attention_plain(q, k, v, pos, window=W,
                                                      band=band),
                       **bf16_attn_tol)
    assert torch.equal(got, sa.sparse_attention(q, k, v, pos, window=W)), \
        "banded decode differs from the dense grid"
    print("  decode: bit for bit equal to the dense grid")
    q_pf = randn(B, N, H, hd)
    pos_pf = torch.arange(N, device=dev, dtype=torch.int32).expand(B, N)
    got_pf = sa.sparse_attention(q_pf, k, v, pos_pf, window=W, banded=True,
                                 q_span=512)
    band_pf = sa.band_for(pos_pf, N, W, 512)
    assert_close(f"prefill kq={N} n_band={band_pf[1]}", got_pf,
                 sa.sparse_attention_plain(q_pf, k, v, pos_pf, window=W,
                                           band=band_pf), **bf16_attn_tol)
    assert torch.equal(got_pf, sa.sparse_attention(q_pf, k, v, pos_pf,
                                                   window=W)), \
        "banded prefill differs from the dense grid"
    print("  prefill: bit for bit equal to the dense grid")
    ms_pf = median_ms(lambda: sa.sparse_attention(
        q_pf, k, v, pos_pf, window=W, banded=True, q_span=512), torch, flush,
        runs=5, warmup=1)
    flops_pf = 4 * H * hd * window_keys(torch, pos_pf, N, W, band_pf)
    kt = k.transpose(1, 2).expand(B, H, N, hd)
    vt = v.transpose(1, 2).expand(B, H, N, hd)
    wmask_pf = ((pos_pf[:, :, None].long()
                 - torch.arange(N, device=dev)[None, None, :]).abs()
                <= W)[:, None]
    sdpa_pf = median_ms(lambda: F.scaled_dot_product_attention(
        q_pf.transpose(1, 2), kt, vt, attn_mask=wmask_pf), torch, flush,
        runs=5, warmup=1)
    print(f"  prefill kernel {ms_pf:.3f} ms, bound {bound(0, flops_pf)[0]:.3f}"
          f" ms, {flops_pf / ms_pf / 1e9:.1f} TFLOP/s over the window's keys;"
          f" SDPA with the window mask (all {N} keys) {sdpa_pf:.3f} ms")
    print(f"  ptxas -v: {attention_ptxas()}")
    del q_pf, got_pf, wmask_pf
    for dt in (f32, torch.int8):
        b_, n_, kq_, h_ = 2, 4100, 700, 4
        qe = randn(b_, kq_, h_, hd, dtype=f32)
        if dt == torch.int8:
            ke = randint(-127, 128, b_, n_, 1, hd).to(torch.int8)
            ve = randint(-127, 128, b_, n_, 1, hd).to(torch.int8)
            kse = torch.rand((b_, n_, 1), generator=gen, device=dev) * 0.02
            vse = torch.rand((b_, n_, 1), generator=gen, device=dev) * 0.02
        else:
            ke, ve = randn(b_, n_, 1, hd, dtype=f32), randn(b_, n_, 1, hd,
                                                            dtype=f32)
            kse = vse = None
        pe = torch.cat([
            torch.sort(randint(0, 1500, b_, 512)).values,
            torch.sort(randint(2000, 3000, b_, kq_ - 512)).values], dim=1)
        kw = dict(k_scale=kse, v_scale=vse, window=64, soft_cap=30.0,
                  kv_len=torch.tensor([n_, 2600], device=dev))
        ge = sa.sparse_attention(qe, ke, ve, pe, banded=True, q_span=1500,
                                 **kw)
        assert_close(f"{dt} K/V ragged kq={kq_} N={n_} kv_len soft_cap", ge,
                     sa.sparse_attention_plain(
                         qe, ke, ve, pe,
                         band=sa.band_for(pe, n_, 64, 1500), **kw),
                     1e-5, 0)
        assert torch.equal(ge, sa.sparse_attention(qe, ke, ve, pe, **kw)), \
            f"{dt} banded differs from the dense grid"
    qt = q.transpose(1, 2)
    wmask = ((pos[:, :, None].long()
              - torch.arange(N, device=dev)[None, None, :]).abs()
             <= W)[:, None]
    flops = 4 * H * hd * window_keys(torch, pos, N, W, band)
    records["sparse_attention_banded"] = dict(
        source="src/repro_torch/csrc/sparse_attention.cu",
        replaces="src/repro/kernels/sparse_attention.py:210",
        max_abs_err=err,
        ms=median_ms(lambda: sa.sparse_attention(
            q, k, v, pos, window=W, banded=True, q_span=span), torch, flush,
            runs=10),
        plain_ms=median_ms(lambda: sa.sparse_attention_plain(
            q, k, v, pos, window=W, band=sa.band_for(pos, N, W, span)),
            torch, flush, runs=3, warmup=1),
        library_ms=median_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=wmask), torch, flush, runs=5, warmup=1),
        bound=bound(2 * (2 * B * N * KVH * hd + 2 * B * kq * H * hd)
                    + 4 * B * kq, flops))
    rec = records["sparse_attention_banded"]
    print(f"  decode kernel {rec['ms']:.3f} ms, {flops / rec['ms'] / 1e9:.1f}"
          f" TFLOP/s over the window's keys (the band of {band[1]} blocks "
          f"would be {4 * B * kq * H * band[1] * 512 * hd / 1e12:.2f} TFLOP);"
          f" SDPA with the window mask (all {N} keys) "
          f"{rec['library_ms']:.3f} ms")
    del qt, wmask

    print("sparse_attention, dense grid at head_dim 256 (bf16 wgmma body)")
    kq_d = 1744
    pos_d = _stratified_positions(torch, gen, B, N, kq_d, 4)
    q_d = randn(B, kq_d, H, hd)
    got_d = sa.sparse_attention(q_d, k, v, pos_d, window=W, banded=True,
                                q_span=q_span_bound(N, kq_d, 4))
    assert_close(f"dense grid kq={kq_d} (q_span "
                 f"{q_span_bound(N, kq_d, 4)}: no band)", got_d,
                 sa.sparse_attention_plain(q_d, k, v, pos_d, window=W),
                 **bf16_attn_tol)
    ms_d = median_ms(lambda: sa.sparse_attention(q_d, k, v, pos_d, window=W),
                     torch, flush, runs=10)
    flops_d = 4 * H * hd * window_keys(torch, pos_d, N, W)
    wmask_d = ((pos_d[:, :, None].long()
                - torch.arange(N, device=dev)[None, None, :]).abs()
               <= W)[:, None]
    sdpa_d = median_ms(lambda: F.scaled_dot_product_attention(
        q_d.transpose(1, 2), kt, vt, attn_mask=wmask_d), torch, flush,
        runs=5, warmup=1)
    print(f"  dense grid hd=256 kq={kq_d}: {ms_d:.3f} ms, bound "
          f"{bound(0, flops_d)[0]:.3f} ms, {flops_d / ms_d / 1e9:.1f} "
          f"TFLOP/s over the window's keys; SDPA with the window mask (all "
          f"{N} keys) {sdpa_d:.3f} ms")
    print(f"  ptxas -v: {attention_ptxas()}")
    del q_d, got_d, k, v, q, kt, vt, wmask_d

    print("rglru_scan (a, b [2, 16384, 4096])")
    # decays in [0.9, 1): a chunk of 64 steps keeps 0.1-100% of its start
    # state, so the carries between chunks decide the result
    T, dr = N, HYBRID["d"]
    a = 1.0 - 0.1 * torch.rand((B, T, dr), generator=gen, device=dev)
    x = torch.randn((B, T, dr), generator=gen, device=dev) * 0.1
    tol = {bf16: (1e-5, 2 ** -7), f32: (1e-5, 1e-5)}
    for dt in (bf16, f32):
        ad, xd = a.to(dt), x.to(dt)
        for flip in (False, True):
            aa = torch.flip(ad, dims=(1,)) if flip else ad
            xx = torch.flip(xd, dims=(1,)) if flip else xd
            got = rs.rglru_scan(aa, xx)
            want = rs.rglru_scan_plain(aa, xx)
            atol, rtol = tol[dt]
            e = float(((got.float() - want.float()).abs()
                       - rtol * want.float().abs()).max())
            print(f"  {dt} {'flipped' if flip else 'forward'}: max_abs_err "
                  f"{max_err(got, want):.3e} (limit {atol:.0e} + {rtol:.1e} "
                  "x |element|)")
            assert e <= atol, f"rglru_scan {dt}: {e} over {atol}"
            if dt == bf16 and not flip:
                err_rs = max_err(got, want)
    for b_, t_, d_ in ((3, 1001, 77), (1, 64, 8)):
        ae = 1.0 - 0.1 * torch.rand((b_, t_, d_), generator=gen, device=dev)
        xe = torch.randn((b_, t_, d_), generator=gen, device=dev) * 0.1
        assert_close(f"f32 ragged B={b_} T={t_} d={d_}", rs.rglru_scan(ae, xe),
                     rs.rglru_scan_plain(ae, xe), 1e-5, 1e-5)
    print(f"  ptxas -v: {lookback_ptxas()}")
    ab, xb = a.to(bf16), x.to(bf16)
    records["rglru_scan"] = dict(
        source="src/repro_torch/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan.py:51", max_abs_err=err_rs,
        ms=median_ms(lambda: rs.rglru_scan(ab, xb), torch, flush),
        plain_ms=median_ms(lambda: rs.rglru_scan_plain(ab, xb), torch, flush,
                           runs=3, warmup=1),
        library_ms=None,
        bound=bound(3 * 2 * B * T * dr, 2 * B * T * dr, F32_FLOPS))
    # the same bytes in one elementwise pass (read a and b, write one
    # tensor, no recurrence): what streaming them costs on this card
    summed = torch.empty_like(ab)
    add_ms = median_ms(lambda: torch.add(ab, xb, out=summed), torch, flush)
    print(f"  kernel {records['rglru_scan']['ms']:.4f} ms; the same bytes "
          f"in one elementwise pass (torch.add of a and b) {add_ms:.4f} ms")
    del a, x, ab, xb, summed
    return records


def check_ssd_kernel(torch, flush, gen):
    """ssd_chunk_scan at Mamba2-370m's decode shape (x [4, 4096, 32, 64],
    ds 128, chunk 256: 16 chunks) in bf16 and f32, and with T < chunk (one
    chunk of 200 rows, ragged 64-row tiles), against the plain chunked
    einsums: f32 within 1e-5 of the largest output (three TF32 products a
    term, partials of at most 32 terms), bf16 within two ulps of the
    largest output.  Inputs as the
    model makes them: dt = softplus(N(0,1) - 3), a = -[1..16] over the
    heads, la the in-chunk cumulative sum of dt * a."""
    import math
    from repro_torch.kernels import ssd_chunk as sc

    t0 = time.perf_counter()
    B, N, H, hd, ds, cs = (MAMBA[k] for k in ("B", "N", "H", "hd", "ds",
                                              "chunk"))
    print(f"ssd_chunk_scan (x [{B}, {N}, {H}, {hd}], ds {ds}, chunk {cs})")

    def inputs(t, dtype):
        return ssd_inputs(torch, gen, t, dtype)

    errs = {}
    for t, dtype in ((N, torch.bfloat16), (N, torch.float32),
                     (200, torch.bfloat16), (200, torch.float32)):
        args = inputs(t, dtype)
        got = sc.ssd_chunk_scan(*args, cs)
        want = sc.ssd_chunk_scan_plain(*args, cs).float()
        assert bool(torch.isfinite(got).all()), "non-finite ssd output"
        top = float(want.abs().max())
        lim = (1e-5 * top if dtype == torch.float32
               else 2 * 2.0 ** (math.floor(math.log2(top)) - 7))
        err = max_err(got, want)
        print(f"  {dtype} T={t}: max_abs_err {err:.3e} (limit {lim:.3e}, "
              f"max |y| {top:.3e})")
        assert err <= lim, f"ssd_chunk_scan {dtype} T={t}: {err} over {lim}"
        errs[(t, dtype)] = err
        del args, got, want
    args = inputs(N, torch.bfloat16)
    nbytes = 2 * 2 * B * N * H * hd + 2 * 2 * B * N * ds + 2 * 4 * B * N * H
    flops = ssd_flops()
    rec = dict(
        source="src/repro_torch/csrc/ssd_chunk.cu",
        replaces="src/repro/kernels/ssd_chunk.py:75",
        max_abs_err=errs[(N, torch.bfloat16)],
        ms=median_ms(lambda: sc.ssd_chunk_scan(*args, cs), torch, flush,
                     runs=20),
        plain_ms=median_ms(lambda: sc.ssd_chunk_scan_plain(*args, cs), torch,
                           flush, runs=5, warmup=1),
        library_ms=None,
        bound=bound(nbytes, flops))
    print(f"  kernel {rec['ms']:.4f} ms ({flops / rec['ms'] / 1e9:.1f} "
          f"TFLOP/s of the {flops / 1e9:.1f} GFLOP the data needs, "
          f"{nbytes / rec['ms'] / 1e6:.1f} GB/s of {nbytes / 1e6:.1f} MB), "
          f"plain {rec['plain_ms']:.3f} ms")
    # the three kernels of a call: device time each, from a profiler window
    # (the L2 flushed clean before every call)
    with new_profiler(torch) as prof:
        for _ in range(10):
            flush()
            sc.ssd_chunk_scan(*args, cs)
        torch.cuda.synchronize()
    for key, us in device_us(prof, "ssd_chunk_").items():
        print(f"  {key[:60]}: {us / 10 / 1e3:.4f} ms a call")
    for name, lines in sorted(ptxas_lines(
            r"(ssd_chunk_(?:states|pass|outputs)[a-z0-9_]*(?:ILb[01]E)?)"
            ).items()):
        name = name.replace("ILb1E", "<true>").replace("ILb0E", "<false>")
        print(f"  ptxas -v {name}: {', '.join(lines)}")
    del args
    names = ssd_f32_row(torch, flush, gen)
    fma = sorted(n for n in names
                 if re.search(r"ssd_chunk_(?:states|outputs)_f32\b", n))
    assert not fma, f"the f32 CUDA-core body ran: {fma}"
    assert any("ssd_chunk_outputs_tf32" in n for n in names), \
        f"no TF32 outputs stage among the f32 call's kernels: {names}"
    print(f"  this check took {time.perf_counter() - t0:.1f} s")
    return {"ssd_chunk_scan": rec}


def ssd_inputs(torch, gen, t: int, dtype):
    """Inputs of ssd_chunk_scan at Mamba2-370m's widths (``MAMBA``) and T =
    t rows, as the model makes them: dt = softplus(N(0,1) - 3), a = -[1..16]
    over the heads, la the in-chunk cumulative sum of dt * a."""
    dev = torch.device("cuda")
    B, H, hd, ds, cs = (MAMBA[k] for k in ("B", "H", "hd", "ds", "chunk"))
    x = torch.randn((B, t, H, hd), generator=gen, device=dev).to(dtype)
    bm = torch.randn((B, t, ds), generator=gen, device=dev).to(dtype)
    cm = torch.randn((B, t, ds), generator=gen, device=dev).to(dtype)
    dt = torch.nn.functional.softplus(
        torch.randn((B, t, H), generator=gen, device=dev) - 3.0)
    a = -torch.linspace(1.0, 16.0, H, device=dev)
    c = min(cs, t)
    la = torch.cumsum((dt * a).reshape(B, t // c, c, H),
                      dim=2).reshape(B, t, H)
    return x, dt, la, bm, cm


def ssd_flops() -> int:
    """The products ssd_chunk_scan's data needs at Mamba2-370m's shape: per
    (batch row, chunk) the causal half of G = C B^T (j <= i), then per head
    the causal half of M X; the chunk states X^T (w o B) and C s_before^T
    only where a state enters a chunk (chunks 1 .. L-1: the last chunk's
    state feeds nothing, the first chunk's entering state is zero)."""
    B, N, H, hd, ds, cs = (MAMBA[k] for k in ("B", "N", "H", "hd", "ds",
                                              "chunk"))
    n_chunks, tri = N // cs, cs * (cs + 1) // 2
    return (2 * B * n_chunks * tri * ds
            + 2 * B * H * (n_chunks * tri * hd
                           + 2 * (n_chunks - 1) * cs * ds * hd))


def device_us(prof, key: str) -> dict:
    """Self device us of each kernel of a profiler window whose name holds
    ``key``, by name."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and key in ev.key:
            us = getattr(ev, "self_device_time_total", None)
            out[ev.key] = ev.self_cuda_time_total if us is None else us
    return out


def ssd_f32_row(torch, flush, gen) -> set:
    """Phase 3's f32 row of ssd_chunk_scan at Mamba2-370m's shape (``f32_row``:
    the kernel's and the plain version's median device ms, library none,
    the bound of f32 bytes and the data's products), then the device ms a
    call of each kernel an f32 call launches (a profiler window, the L2
    flushed clean before every call).  Returns those kernels' names.  It
    asserts nothing of the body, so it also times an older tree's."""
    from repro_torch.kernels import ssd_chunk as sc

    B, N, H, hd, ds, cs = (MAMBA[k] for k in ("B", "N", "H", "hd", "ds",
                                              "chunk"))
    args = ssd_inputs(torch, gen, N, torch.float32)
    nbytes = 2 * 4 * B * N * H * hd + 2 * 4 * B * N * ds + 2 * 4 * B * N * H
    flops = ssd_flops()
    ms = median_ms(lambda: sc.ssd_chunk_scan(*args, cs), torch, flush,
                   runs=20)
    plain_ms = median_ms(lambda: sc.ssd_chunk_scan_plain(*args, cs), torch,
                         flush, runs=5, warmup=1)
    f32_row(f"ssd_chunk_scan Mamba2-370m f32 (x [{B}, {N}, {H}, {hd}], ds "
            f"{ds}, chunk {cs})", ms, plain_ms, None, nbytes, flops)
    with new_profiler(torch) as prof:
        for _ in range(10):
            flush()
            sc.ssd_chunk_scan(*args, cs)
        torch.cuda.synchronize()
    kernels = device_us(prof, "ssd_chunk_")
    for key, us in kernels.items():
        print(f"  f32 {key[:70]}: {us / 10 / 1e3:.4f} ms a call")
    del args
    return set(kernels)


# ---------------------------------------------------------------------------
# Phases 4 and 5: decode
# ---------------------------------------------------------------------------

def baseline_strategies(cfg):
    """The baseline strategies, as the registry builds them from the
    config's spec (so each runs the config's adaptive budget, the one SPA
    runs), and SPACache with the incremental identifier."""
    from repro_torch.core.strategy import SPACache, strategy_from_spec
    out = {ident: strategy_from_spec(dataclasses.replace(
        cfg.spa, identifier=ident)) for ident in BASELINES[:-1]}
    out["singular_incremental"] = dataclasses.replace(
        SPACache.from_spec(cfg.spa), incremental_ident=True)
    return out


def decode_parity_phase(torch):
    """Phase 4: 2-layer full-width LLaDA through both backends."""
    print("decode parity (2-layer full-width LLaDA, CudaBackend vs "
          "TorchBackend)")
    # f32: the kernels agree with the plain versions to FMA order.
    setup = _parity_setup(torch, "float32")
    decode_parity(torch, 1e-5, setup, setup[2], "singular")
    for name, strat in baseline_strategies(setup[0]).items():
        decode_parity(torch, 1e-5, setup, strat, name)
    del setup
    torch.cuda.empty_cache()
    # bf16, the main path's kernels (tensor-core attention, bf16 proxies):
    # each call agrees to one bf16 ulp (2^-7), so one step's buffers and
    # logits to a few ulps of their largest value (an H100 read 1.1e-2 and
    # 6.0e-3); the limit is four ulps.
    setup = _parity_setup(torch, "bfloat16")
    lockstep_parity(torch, 2 ** -5, 2 ** -5, setup, setup[2], "singular")
    # the baselines: a step may commit another slot where two bf16
    # confidences tie within the step's logit difference (checked)
    for name, strat in baseline_strategies(setup[0]).items():
        lockstep_parity(torch, 2 ** -5, 2 ** -5, setup, strat, name,
                        strict=False)
    del setup
    torch.cuda.empty_cache()
    print("paged decode parity (2-layer full-width f32 LLaDA, pages of "
          f"{PAGE})")
    paged_parity(torch, 1e-5)
    torch.cuda.empty_cache()


def _parity_setup(torch, dtype: str):
    """A 2-layer, full-width LLaDA, its proxies and a B=4 prompt of 48."""
    from repro_torch.configs import get_arch
    from repro_torch.core.strategy import SPACache
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_arch("llada-8b"), n_layers=2,
                              param_dtype=dtype)
    params = transformer.init_params(cfg, seed=7)
    strat = SPACache.from_spec(cfg.spa)
    proxies = strat.build_proxies(params, cfg)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size - 1, (4, 48), generator=gen)
    return cfg, params, strat, proxies, prompt


def _cache_rel_diff(got, want) -> float:
    """Largest difference of any cache buffer, over that buffer's largest
    value."""
    worst = 0.0
    for kind, bufs in got.items():
        for nm, t in bufs.items():
            w = want[kind][nm]
            worst = max(worst, max_err(t, w) / max(
                float(w.float().abs().max()), 1e-30))
    return worst


def _dequantized(cache):
    """An int8 cache's values: each int8 buffer times its ``_scale``
    buffer, in f32 (the scales dropped); a float cache as it is.  Two
    backends may round one bf16 value to codes several apart where their
    row maxima (the scales) differ by an ulp; the values stay close."""
    out = {}
    for kind, bufs in cache.items():
        out[kind] = {}
        for nm, t in bufs.items():
            scale = bufs.get(nm + "_scale")
            if nm.endswith("_scale") and nm[:-6] in bufs:
                continue
            out[kind][nm] = (t if scale is None
                             else t.float() * scale.float()[..., None])
    return out


@contextlib.contextmanager
def oracle_launches_nothing(label: str, active: bool = True):
    """Around the ``TorchBackend`` side of a comparison: no kernel wrapper
    may count a launch in it (the oracle runs plain PyTorch only)."""
    from repro_torch.kernels import _lib
    before = _lib.launch_counts()
    yield
    if active:
        after = _lib.launch_counts()
        moved = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        assert not moved, f"{label}: the TorchBackend side launched {moved}"


def decode_parity(torch, cache_tol: float, setup, strat, label: str,
                  quantized: bool = False):
    """f32: a whole decode through ``CudaBackend`` and ``TorchBackend``;
    tokens and step counts must be identical, and every cache buffer must
    agree within ``cache_tol`` of its largest value.  ``quantized`` (an
    int8 cache): the int8 codes within 1 instead, the f16 scales within
    2^-10 (one f16 ulp) and the float buffers (the identifiers) of the
    first layer within ``cache_tol``: they are projected from the
    embeddings, which no int8 buffer touched.  Later layers project rows of
    the layer before's int8 H^c, where a code apart moves a row by its
    scale; their float buffers are held to 2^-7 (one int8 step) of their
    largest value.  A control decode whose identifier projection is
    rounded to bf16 must then break the first layer's limit."""
    from repro_torch.dlm.session import DecodeSession

    cfg, params, _, proxies, prompt = setup
    proxies = proxies if strat.uses_proxy_mat else None

    def decode(name):
        with oracle_launches_nothing(label, name == "torch"):
            sess = DecodeSession(params, cfg, strategy=strat, backend=name,
                                 spa_proxies=proxies)
            sess.prefill(prompt, 16)
            toks, info = sess.run()
            torch.cuda.synchronize()
        return toks.cpu(), info["steps"], sess.state.cache

    def floats(cache, first_only=False):
        """The float buffers of an int8 cache (the first layer's alone)."""
        return {k: {n: t[:1] if first_only else t for n, t in b.items()
                    if t.dtype != torch.int8 and not n.endswith("_scale")}
                for k, b in cache.items()
                if not first_only or k == cfg.layer_kinds[0]}

    out = {name: decode(name) for name in ("cuda", "torch")}
    n_diff = int((out["cuda"][0] != out["torch"][0]).sum())
    assert n_diff == 0, \
        f"{label} float32: CudaBackend and TorchBackend differ in " \
        f"{n_diff} tokens"
    assert out["cuda"][1] == out["torch"][1], f"{label}: step counts differ"
    got, want = out["cuda"][2], out["torch"][2]
    if quantized:
        codes = max(max_err(t, want[k][n]) for k, b in got.items()
                    for n, t in b.items() if t.dtype == torch.int8)
        scales = _cache_rel_diff(
            *({k: {n: t for n, t in b.items() if n.endswith("_scale")}
               for k, b in c.items()} for c in (got, want)))
        first = _cache_rel_diff(floats(got, True), floats(want, True))
        print(f"  {label} float32: int8 codes within {codes:g}, f16 scales "
              f"within {scales:.3e} of their largest value, first layer's "
              f"identifiers within {first:.3e}")
        assert codes <= 1, f"{label}: int8 codes differ by {codes}"
        assert scales <= 2 ** -10, f"{label}: scales differ by {scales}"
        assert first <= cache_tol, \
            f"{label}: first layer's identifiers differ by {first}"
        got, want = floats(got), floats(want)
    worst = _cache_rel_diff(got, want)
    print(f"  {label} float32: tokens identical, steps {out['cuda'][1]}, "
          f"max cache diff {worst:.3e} of the buffer's largest value")
    assert worst <= (2 ** -7 if quantized else cache_tol), \
        f"{label}: cache buffers differ by {worst}"
    if quantized:
        from repro_torch.kernels import proxy_score as ps
        exact = ps.proxy_score

        def rounded(x, mat, p_cached, **kw):
            scores, p_now = exact(x, mat, p_cached, **kw)
            return scores, p_now.to(torch.bfloat16).to(p_now.dtype)

        ps.proxy_score = rounded
        try:
            ctl = decode("cuda")[2]
        finally:
            ps.proxy_score = exact
        first = _cache_rel_diff(floats(ctl, True), floats(out["torch"][2],
                                                          True))
        whole = _cache_rel_diff(floats(ctl), want)
        print(f"  {label} control, identifier projection rounded to bf16: "
              f"first layer's identifiers {first:.3e} (limit "
              f"{cache_tol:g}), all float buffers {whole:.3e}")
        assert first > cache_tol, \
            f"{label}: the first layer's limit misses a bf16 projection"
    del out


def lockstep_parity(torch, logit_tol: float, cache_tol: float, setup,
                    strat, label: str, strict: bool = True):
    """bf16, the main path's kernel variants: a whole decode through
    ``CudaBackend``, and before every step ``TorchBackend`` is given a copy
    of the CUDA session's state and takes the same step.  From the same
    state, the step's candidate logits must agree within ``logit_tol`` and
    every cache buffer (an int8 one by its dequantized values) within
    ``cache_tol`` of its largest value, and the step's tokens must be
    identical.  A free-running bf16 pair is not
    compared token for token: the one-ulp differences of each call pile up
    in the caches over the steps, and with random weights the bf16
    confidences over the 126k vocabulary tie at the ulp, so a later step
    may commit another slot.

    With ``strict`` False a step whose tokens differ passes only if the
    measured logit difference explains it: in the CUDA step's own
    log-confidences the slot TorchBackend committed trails the CUDA
    choice by at most 4 x max|logit_cuda - logit_torch| of that step (each
    backend's log-confidence of a slot lies within twice that difference
    of the other's), and likewise for the token at a shared slot."""
    from repro_torch.dlm.decoding import DecodeState
    from repro_torch.dlm.scheduler import ConfidenceScheduler
    from repro_torch.dlm.session import DecodeSession

    @dataclasses.dataclass(frozen=True)
    class Recording(ConfidenceScheduler):
        last: list = dataclasses.field(default_factory=list, compare=False,
                                       hash=False)

        def select_commits(self, view):
            commit, pred = super().select_commits(view)
            self.last[:] = [view.logits.float(), view.conf, commit, pred]
            return commit, pred

    def flip_margin(a, b) -> float:
        """The largest gap, over rows whose commits differ, between the
        CUDA choice and TorchBackend's in the CUDA log-confidences (or
        logits, for another token at the same slot), over the step's
        largest logit difference."""
        la, conf_a, commit_a, pred_a = a
        lb, _, commit_b, pred_b = b
        finite = torch.isfinite(la)
        delta = float((la - lb).abs()[finite].max())
        worst = 0.0
        for row in range(la.shape[0]):
            ca = int(commit_a[row].nonzero()[0])
            cb = int(commit_b[row].nonzero()[0])
            if ca != cb:
                gap = float(torch.log(conf_a[row, ca] / conf_a[row, cb]))
            elif int(pred_a[row, ca]) != int(pred_b[row, cb]):
                gap = float(la[row, ca, pred_a[row, ca]]
                            - la[row, ca, pred_b[row, cb]])
            else:
                continue
            worst = max(worst, gap / max(delta, 1e-30))
        return worst

    def clone(state: DecodeState) -> DecodeState:
        return state._replace(
            tokens=state.tokens.clone(), committed=state.committed.clone(),
            n_masked=state.n_masked.clone(),
            cache={kind: {nm: t.clone() for nm, t in bufs.items()}
                   for kind, bufs in state.cache.items()})

    cfg, params, _, proxies, prompt = setup
    proxies = proxies if strat.uses_proxy_mat else None
    rec = {name: Recording() for name in ("cuda", "torch")}
    sess = {name: DecodeSession(params, cfg, strategy=strat, backend=name,
                                spa_proxies=proxies, scheduler=rec[name])
            for name in rec}
    for name, s in sess.items():
        with oracle_launches_nothing(label, name == "torch"):
            s.prefill(prompt, 16)
    a, b = sess["cuda"], sess["torch"]
    prefill_diff = _cache_rel_diff(_dequantized(a.state.cache),
                                   _dequantized(b.state.cache))
    logit_diff = cache_diff = margin = 0.0
    flips = steps = 0
    while not a.done:
        b.state = clone(a.state)
        a.step()
        with oracle_launches_nothing(label):
            b.step()
        steps += 1
        la, lb = rec["cuda"].last[0], rec["torch"].last[0]
        if not torch.equal(a.state.tokens, b.state.tokens):
            margin = max(margin, flip_margin(rec["cuda"].last,
                                             rec["torch"].last))
        finite = torch.isfinite(lb)
        assert torch.equal(finite, torch.isfinite(la)), "non-finite logits"
        logit_diff = max(logit_diff, float(
            (la - lb).abs()[finite].max() / lb.abs()[finite].max()))
        cache_diff = max(cache_diff,
                         _cache_rel_diff(_dequantized(a.state.cache),
                                         _dequantized(b.state.cache)))
        flips += int(not torch.equal(a.state.tokens, b.state.tokens))
    torch.cuda.synchronize()
    assert steps == 16, f"{label} bf16 lockstep took {steps} steps"
    print(f"  {label} bfloat16 lockstep: {steps} steps, prefill cache diff "
          f"{prefill_diff:.3e}, step cache diff {cache_diff:.3e}, logits "
          f"diff {logit_diff:.3e} (each of the largest value), steps whose "
          f"tokens differ from the same state: {flips}"
          + (f" (largest gap {margin:.3f} x the step's logit difference)"
             if flips else ""))
    assert max(prefill_diff, cache_diff) <= cache_tol, \
        f"{label} bf16 cache buffers differ by " \
        f"{max(prefill_diff, cache_diff)}"
    assert logit_diff <= logit_tol, \
        f"{label} bf16 logits differ by {logit_diff}"
    if strict:
        assert flips == 0, f"{label} bf16 tokens differ after {flips} steps"
    else:
        assert margin <= 4.0, \
            f"{label} bf16: {flips} steps commit differently, by a gap of " \
            f"{margin:.3f} x the logit difference (not a tie)"
    del sess


def paged_parity(torch, cache_tol: float):
    """Paged sessions of the 2-layer full-width f32 LLaDA (B=4, prompt 48
    + gen 16, pages of 16 rows): through ``CudaBackend`` they must give the
    tokens of the dense ``CudaBackend`` session on full-length rows, and the
    tokens and step counts of the paged ``TorchBackend`` session there and
    on rows of mixed ``kv_len`` (64, 32, 48 and 16: short rows' tails map to
    the zero page); arenas within ``cache_tol`` of their largest value."""
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.serving.pool import PagePool

    cfg, params, strat, proxies, prompt = _parity_setup(torch, "float32")
    gen = 16
    n = prompt.shape[1] + gen
    n_log = n // PAGE

    def paged(backend, tokens, active, kv_lens):
        pool = PagePool(cfg, n_pages=1 + len(kv_lens) * n_log,
                        page_size=PAGE, strategy=strat)
        pt = [pool.page_table_row(pool.alloc(kv // PAGE), n)
              for kv in kv_lens]
        with oracle_launches_nothing("paged", backend == "torch"):
            sess = DecodeSession(params, cfg, strategy=strat,
                                 backend=backend, spa_proxies=proxies)
            sess.attach(tokens, active=active, kv_len=torch.tensor(kv_lens),
                        arenas=pool.arenas_for(strat),
                        page_table=torch.tensor(pt))
            toks, info = sess.run()
            torch.cuda.synchronize()
        return toks.cpu(), info["steps"], sess.state.cache.arenas

    dense = DecodeSession(params, cfg, strategy=strat, backend="cuda",
                          spa_proxies=proxies)
    dense.prefill(prompt, gen)
    dense_toks = dense.run()[0].cpu()
    del dense
    canvas = torch.full((4, n), cfg.mask_id, dtype=torch.long)
    canvas[:, :prompt.shape[1]] = prompt
    active = torch.zeros((4, n), dtype=torch.bool)
    active[:, prompt.shape[1]:] = True
    mixed = torch.full((4, n), cfg.mask_id, dtype=torch.long)
    mixed_active = torch.zeros((4, n), dtype=torch.bool)
    kv_mixed = []
    for i, (p_len, g_len) in enumerate(((48, 16), (16, 16), (32, 16),
                                        (8, 8))):
        mixed[i, :p_len] = prompt[i, :p_len]
        mixed_active[i, p_len:p_len + g_len] = True
        kv_mixed.append(p_len + g_len)
    for name, toks, act, kv in (("full-length rows", canvas, active,
                                 [n] * 4),
                                ("mixed kv_len", mixed, mixed_active,
                                 kv_mixed)):
        c_toks, c_steps, c_arenas = paged("cuda", toks, act, kv)
        t_toks, t_steps, t_arenas = paged("torch", toks, act, kv)
        n_diff = int((c_toks != t_toks).sum())
        assert n_diff == 0, f"paged {name}: Cuda/Torch differ in {n_diff}"
        assert c_steps == t_steps, f"paged {name}: step counts differ"
        if name == "full-length rows":
            assert torch.equal(c_toks, dense_toks), \
                "paged and dense CudaBackend sessions differ"
        for bufs in c_arenas.values():
            for nm, t in bufs.items():
                assert not t[:, 0].any(), f"{nm}: the zero page was written"
        worst = _cache_rel_diff(c_arenas, t_arenas)
        print(f"  paged {name}: tokens identical to TorchBackend"
              f"{' and to the dense session' if kv == [n] * 4 else ''}, "
              f"steps {c_steps}, max arena diff {worst:.3e}")
        assert worst <= cache_tol, f"paged arenas differ by {worst}"
    del params, proxies


# kernel-name fragments -> the share each group takes of the device time
# (first match wins: the paged proxy_score instance before the dense one);
# a fragment may be a tuple of substrings that must all occur
KERNEL_GROUPS = (("gather_pages + scatter_pages", ("page_copy_kernel",)),
                 ("scatter_rows_paged", ("rows_paged_kernel",)),
                 ("cosine_drift (+ paged)", ("cosine_drift_kernel",)),
                 ("proxy_score_paged", ("PagedRows",)),
                 ("proxy_score, wide projection",
                  (("proxy_wgmma", "false"), ("proxy_tf32", "false"))),
                 ("proxy_score", ("proxy_wgmma", "proxy_tf32")),
                 ("gather_norm", ("gather_norm",)),
                 ("sparse_attention (dense + banded)",
                  ("attention_bf16_wgmma", "attention_i8_wgmma",
                   "attention_tf32_wgmma")),
                 ("rglru_scan", ("rglru_lookback",)),
                 ("ssd_chunk_scan", ("ssd_chunk_",)),
                 ("scatter_update_multi", ("scatter_kernel",)),
                 ("matmul (cuBLAS)", ("gemm", "xmma", "cutlass", "sm90_",
                                      "nvjet")))


def new_profiler(torch):
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def profile_steps(torch, step, n_steps: int, label: str):
    """Device time by kernel group and the device-busy share of a window of
    ``n_steps`` steps, from a ``torch.profiler`` trace.  Returns (wall
    ms/step, device ms/step), device None where the trace shows none."""
    torch.cuda.synchronize()
    with new_profiler(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return report_profile(prof, n_steps, wall_us, label)


def _matches(name: str, key) -> bool:
    return (key in name if isinstance(key, str)
            else all(k in name for k in key))


def report_profile(prof, n_steps: int, wall_us: float, label: str) -> None:
    from torch.autograd import DeviceType
    groups = {name: 0.0 for name, _ in KERNEL_GROUPS}
    groups["other kernels"] = 0.0
    calls = dict.fromkeys(groups, 0)
    others = {}
    busy = 0.0
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        busy += t
        group = next((name for name, keys in KERNEL_GROUPS
                      if any(_matches(ev.key, k) for k in keys)),
                     "other kernels")
        groups[group] += t
        calls[group] += ev.count
        if group == "other kernels":
            others[ev.key] = others.get(ev.key, 0.0) + t
    if busy == 0:
        print(f"  {label} profile: the trace shows no device time")
        return wall_us / n_steps / 1e3, None
    print(f"  {label} profile over {n_steps} steps: {wall_us / n_steps / 1e3:.2f}"
          f" ms/step wall, device busy {busy / wall_us:.1%}")
    for name, t in sorted(groups.items(), key=lambda kv: -kv[1]):
        per_call = (f", {calls[name] / n_steps:g} calls/step, "
                    f"{t / calls[name]:.2f} us/call" if calls[name] else "")
        print(f"    {name:>22}: {t / n_steps / 1e3:8.3f} ms/step "
              f"({t / busy:.1%} of device time{per_call})")
    for name, t in sorted(others.items(), key=lambda kv: -kv[1])[:6]:
        print(f"      other: {t / n_steps / 1e3:8.3f} ms/step  {name[:90]}")
    return wall_us / n_steps / 1e3, busy / n_steps / 1e3


def llada_setup(torch):
    """LLaDA-8B's random bf16 weights, its ``SPACache`` and SVD proxies:
    (cfg, params, strat, proxies), shared by phases 5-7, 12 and 14-16
    (``llada_cut`` of them in phases 6, 7, 12, 14 and 15)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.strategy import SPACache
    from repro_torch.models import transformer

    cfg = get_arch("llada-8b")
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"  init {cfg.name} bf16 weights: "
          f"{time.perf_counter() - t0:.2f} s")
    strat = SPACache.from_spec(cfg.spa)
    t0 = time.perf_counter()
    proxies = strat.build_proxies(params, cfg)
    torch.cuda.synchronize()
    print(f"  SVD proxies (32 x [4096, 4096] -> r=128): "
          f"{time.perf_counter() - t0:.2f} s")
    return cfg, params, strat, proxies


def llada_cut(cfg, params, proxies, layers: int = CUT_LAYERS):
    """A model cut to its first ``layers`` layers (LLaDA-8B in phases 6, 7,
    12, 14, 15 and 17(a), RecurrentGemma-9B in 17(c)): the same widths, the
    weights and SVD proxies views of the full model's first layers of each
    kind, the budget's peak layer scaled with the depth.  Returns (cfg,
    params, strat, proxies)."""
    from repro_torch.core.strategy import SPACache

    cut_kinds = [cfg.kind_of_layer(l) for l in range(layers)]

    def head(tree, n):
        if isinstance(tree, dict):
            return {k: head(v, n) for k, v in tree.items()}
        return tree[:n]

    def heads(stacks):
        return {kind: head(t, cut_kinds.count(kind))
                for kind, t in stacks.items() if kind in cut_kinds}

    peak = cfg.spa.resolved_layer_peak(cfg.n_layers)
    spa = dataclasses.replace(
        cfg.spa, layer_peak=max(1, round(peak * layers / cfg.n_layers)))
    cut = dataclasses.replace(cfg, n_layers=layers, spa=spa)
    return (cut, dict(params, blocks=heads(params["blocks"])),
            SPACache.from_spec(spa), heads(proxies))


def main_path(torch, cfg, params, strat, proxies):
    """Phase 5: the SPA decode to completion, a profiled window, then
    NoCache steps.  Returns the launches of the SPA decode."""
    from repro_torch.core import spa_layer
    from repro_torch.core.strategy import NoCache
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.kernels import _lib

    gen = torch.Generator().manual_seed(11)
    b, p_len, g_len = 4, 256, GEN_LEN
    prompt = torch.randint(0, cfg.vocab_size - 1, (b, p_len), generator=gen)

    _lib.reset_launch_counts()
    sess = DecodeSession(params, cfg, strategy=strat, backend="cuda",
                         spa_proxies=proxies)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.prefill(prompt, g_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks, info = sess.run()
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = _lib.launch_counts()
    gen_span = toks[:, p_len:]
    assert int((gen_span == cfg.mask_id).sum()) == 0, "open slots remain"
    assert int(sess.state.n_masked.max()) == 0, "n_masked not drained"
    assert bool(sess.last_info["row_finite"].all()), "non-finite hidden"
    for name in SESSION_KERNELS:
        assert launches[name] > 0, \
            f"kernel {name} never launched on the main path"
    steps = info["steps"]
    spa_ms = t_run / steps * 1e3
    print(f"  SPA: steps {steps}, prefill {t_prefill:.3f} s, decode "
          f"{t_run:.3f} s, {spa_ms:.2f} ms/step, "
          f"{b * g_len / t_run:.1f} generated tokens/s")
    print(f"  launches on the main path: {launches}")
    print(f"  per-layer k: {spa_layer.layer_ks(cfg, strat, p_len + g_len)}")
    del sess

    # a short profiled window of SPA steps (outside the timed run above)
    sess = DecodeSession(params, cfg, strategy=strat, backend="cuda",
                         spa_proxies=proxies)
    sess.prefill(prompt, g_len)
    sess.step()
    profile_steps(torch, sess.step, 4, "SPA")
    del sess

    base = DecodeSession(params, cfg, strategy=NoCache(), backend="cuda")
    base.prefill(prompt, g_len, use_cache=False)
    base.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        base.step()
    torch.cuda.synchronize()
    base_ms = (time.perf_counter() - t0) / 16 * 1e3
    print(f"  NoCache: {base_ms:.2f} ms/step over 16 steps "
          f"(SPA {spa_ms:.2f} ms/step, ratio {base_ms / spa_ms:.2f}x)")
    profile_steps(torch, base.step, 2, "NoCache")
    del base
    return launches


# ---------------------------------------------------------------------------
# Phases 8 and 9: the RecurrentGemma-9B hybrid
# ---------------------------------------------------------------------------

def _hybrid_setup(torch, dtype: str):
    """A full-width RecurrentGemma of 3 layers (one period: rglru, rglru,
    local), its proxies and a B=2 prompt of N - 16 = 16368 rows, so the
    local layer (k = 2144, q_span 8192) runs the banded grid."""
    from repro_torch.configs import get_arch
    from repro_torch.core.strategy import SPACache
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_arch("recurrentgemma-9b"), n_layers=3,
                              param_dtype=dtype)
    params = transformer.init_params(cfg, seed=7)
    strat = SPACache.from_spec(cfg.spa)
    proxies = strat.build_proxies(params, cfg)
    gen = torch.Generator().manual_seed(5)
    prompt = torch.randint(0, cfg.vocab_size - 1,
                           (HYBRID["B"], HYBRID["N"] - 16), generator=gen)
    return cfg, params, strat, proxies, prompt


def hybrid_parity(torch):
    """Phase 8: the 3-layer full-width hybrid through CudaBackend and
    TorchBackend: f32 free-running (identical tokens), bf16 in lockstep
    (strict: identical tokens from the same state every step)."""
    from repro_torch.core import spa_layer
    from repro_torch.kernels import _lib

    setup = _hybrid_setup(torch, "float32")
    ks = spa_layer.layer_ks(setup[0], setup[2], HYBRID["N"])
    print(f"  per-layer k {ks}; the local layer's q_span "
          f"{spa_layer.q_span_bound(HYBRID['N'], ks[2], 4)}")
    _lib.reset_launch_counts()
    decode_parity(torch, 1e-5, setup, setup[2], "hybrid singular")
    counts = _lib.launch_counts()
    assert counts["sparse_attention_banded"] > 0 and counts["rglru_scan"] > 0
    del setup
    torch.cuda.empty_cache()
    setup = _hybrid_setup(torch, "bfloat16")
    lockstep_parity(torch, 2 ** -5, 2 ** -5, setup, setup[2],
                    "hybrid singular")
    del setup
    torch.cuda.empty_cache()


def hybrid_main_path(torch, keep: bool = False):
    """Phase 9: RecurrentGemma-9B (38 layers, bf16, random weights), B=2,
    prompt 16128 + gen 256 (N = 16384), DecodeSession.run with SPACache,
    the confidence scheduler and CudaBackend for HYBRID_STEPS steps; then
    a profiled window and a few NoCache steps.  Returns the launches of
    the SPA run (prefill and steps), and with ``keep`` the weights and
    proxies (phase 17(c) serves their first layers), else None."""
    from repro_torch.configs import get_arch
    from repro_torch.core import spa_layer
    from repro_torch.core.strategy import NoCache, SPACache
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.kernels import _lib
    from repro_torch.kernels.sparse_attention import banded_engages
    from repro_torch.models import transformer

    cfg = get_arch("recurrentgemma-9b")
    b, n = HYBRID["B"], HYBRID["N"]
    p_len = n - HYBRID_GEN
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"  init {cfg.name} bf16 weights ({cfg.param_count() / 1e9:.2f} B "
          f"parameters): {time.perf_counter() - t0:.2f} s")
    strat = SPACache.from_spec(cfg.spa)
    proxies = strat.build_proxies(params, cfg)
    ks = spa_layer.layer_ks(cfg, strat, n)
    attn = [l for l in range(cfg.n_layers)
            if cfg.kind_of_layer(l) == "local"]
    banded = [l for l in attn if banded_engages(
        n, cfg.window, True, spa_layer.q_span_bound(
            n, ks[l], spa_layer.stratify_blocks_for(n, ks[l])))]
    print(f"  attention layers {attn}: k {[ks[l] for l in attn]}, banded "
          f"{banded}")
    gen = torch.Generator().manual_seed(13)
    prompt = torch.randint(0, cfg.vocab_size - 1, (b, p_len), generator=gen)

    _lib.reset_launch_counts()
    sess = DecodeSession(params, cfg, strategy=strat, backend="cuda",
                         spa_proxies=proxies)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.prefill(prompt, HYBRID_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    at_prefill = _lib.launch_counts()
    t0 = time.perf_counter()
    _, info = sess.run(HYBRID_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = _lib.launch_counts()
    steps = info["steps"]
    assert steps == HYBRID_STEPS, f"hybrid ran {steps} steps"
    assert bool(sess.last_info["row_finite"].all()), "non-finite hidden"
    for name in HYBRID_KERNELS:
        assert launches[name] > 0, \
            f"kernel {name} never launched on the hybrid path"
    per_step = {k: (launches[k] - at_prefill[k]) / steps
                for k in HYBRID_KERNELS}
    assert per_step["sparse_attention_banded"] == len(banded)
    assert per_step["sparse_attention"] == len(attn) - len(banded)
    assert per_step["rglru_scan"] == 2 * (cfg.n_layers - len(attn))
    spa_ms = t_run / steps * 1e3
    print(f"  SPA: prefill {t_prefill:.3f} s, {steps} steps in {t_run:.3f} s"
          f", {spa_ms:.2f} ms/step; committed "
          f"{int((sess.state.tokens[:, p_len:] != cfg.mask_id).sum())} of "
          f"{b * HYBRID_GEN} slots")
    print(f"  launches at prefill: "
          f"{ {k: at_prefill[k] for k in HYBRID_KERNELS} }")
    print(f"  launches per step: {per_step}")
    spa_wall, spa_dev = profile_steps(torch, sess.step, 3, "hybrid SPA")
    del sess
    torch.cuda.empty_cache()

    base = DecodeSession(params, cfg, strategy=NoCache(), backend="cuda")
    base.prefill(prompt, HYBRID_GEN, use_cache=False)
    base.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        base.step()
    torch.cuda.synchronize()
    base_ms = (time.perf_counter() - t0) / 4 * 1e3
    base_wall, base_dev = profile_steps(torch, base.step, 2,
                                        "hybrid NoCache")
    print(f"  NoCache: {base_ms:.2f} ms/step over 4 steps; SPA/NoCache "
          f"wall {spa_ms / base_ms:.3f} (profiled windows "
          f"{spa_wall / base_wall:.3f})"
          + (f", device time {spa_dev:.2f} / {base_dev:.2f} ms/step = "
             f"{spa_dev / base_dev:.3f}" if spa_dev and base_dev else ""))
    del base
    kept = (params, proxies) if keep else None
    del params, proxies
    torch.cuda.empty_cache()
    return launches, kept


# ---------------------------------------------------------------------------
# Phases 10 and 11: Mamba2-370m (SSD blocks only, NoCache)
# ---------------------------------------------------------------------------

def _mamba_setup(torch, dtype: str, n_layers: int = 3):
    """A full-width Mamba2 of ``n_layers`` SSD blocks and a B=4 prompt of
    N - 16 = 4080 rows (its spa identifier is "none": NoCache)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.strategy import resolve_strategy
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_arch("mamba2-370m"), n_layers=n_layers,
                              param_dtype=dtype)
    params = transformer.init_params(cfg, seed=7)
    gen = torch.Generator().manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size - 1,
                           (MAMBA["B"], MAMBA["N"] - 16), generator=gen)
    return cfg, params, resolve_strategy(cfg), None, prompt


def mamba_parity(torch):
    """Phase 10: the 3-layer full-width Mamba2 through CudaBackend and
    TorchBackend.  f32 free-running: identical tokens and step counts, and
    the final canvas's hidden states within 1e-5 of their largest value.
    bf16 in lockstep (logits within 2^-5 of their largest value; a step
    that commits another slot must be explained by a tie)."""
    from repro_torch.core.strategy import NoCache
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer

    setup = _mamba_setup(torch, "float32")
    cfg, params, strat, _, prompt = setup
    assert isinstance(strat, NoCache), type(strat).__name__
    _lib.reset_launch_counts()
    out, walls = {}, {}
    for name in ("cuda", "torch"):
        with oracle_launches_nothing("mamba2", name == "torch"):
            sess = DecodeSession(params, cfg, backend=name)
            sess.prefill(prompt, 16)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks, info = sess.run()
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            h_in = transformer.embed_inputs(params, cfg, {"tokens": toks})
            h = transformer.forward_hidden(
                params, cfg, h_in, strategy=strat.with_backend(name))[0]
            torch.cuda.synchronize()
        out[name] = (toks.cpu(), info["steps"], h)
        if name == "cuda":
            launches = _lib.launch_counts()["ssd_chunk_scan"]
            scan_us, per_step = _scan_in_place(torch, params, cfg, h_in,
                                               strat)
    assert launches > 0, "ssd_chunk_scan never launched (mamba2 parity)"
    n_diff = int((out["cuda"][0] != out["torch"][0]).sum())
    assert n_diff == 0, f"mamba2 float32: backends differ in {n_diff} tokens"
    assert out["cuda"][1] == out["torch"][1] == 16, "step counts differ"
    h_c, h_t = out["cuda"][2], out["torch"][2]
    h_diff = max_err(h_c, h_t) / float(h_t.abs().max())
    print(f"  mamba2 float32: tokens identical, steps {out['cuda'][1]}, "
          f"ssd_chunk_scan launches {launches}, final hidden states differ "
          f"by {h_diff:.3e} of their largest value")
    print(f"  mamba2 float32 decode wall: CudaBackend {walls['cuda']:.3f} s "
          f"({walls['cuda'] / out['cuda'][1] * 1e3:.2f} ms/step), "
          f"TorchBackend {walls['torch']:.3f} s; f32 ssd_chunk_scan in "
          f"place {scan_us:.2f} us a call (its three kernels), {per_step} "
          f"launches a step")
    assert h_diff <= 1e-5, f"mamba2 float32 hidden states differ by {h_diff}"
    del setup, params, out, h_c, h_t
    torch.cuda.empty_cache()
    setup = _mamba_setup(torch, "bfloat16")
    lockstep_parity(torch, 2 ** -5, 2 ** -5, setup, setup[2], "mamba2",
                    strict=False)
    # the bf16 stack rounds most one-ulp differences of the scan away; show
    # how far one forward of the canvas moves between the two backends
    cfg, params, strat, _, prompt = setup
    canvas = torch.cat([prompt, torch.full((prompt.shape[0], 16),
                                           cfg.mask_id)], 1)
    h0 = transformer.embed_inputs(
        params, cfg, {"tokens": canvas.to(params["embed"].device)})
    hs = {}
    for name in ("cuda", "torch"):
        with oracle_launches_nothing("mamba2 bf16 forward", name == "torch"):
            hs[name] = transformer.forward_hidden(
                params, cfg, h0, strategy=strat.with_backend(name))[0]
    rel = max_err(hs["cuda"], hs["torch"]) / float(hs["torch"].abs().max())
    print(f"  mamba2 bfloat16 forward of the canvas: hidden states differ by "
          f"{rel:.3e} of their largest value")
    del setup, params, hs, h0
    torch.cuda.empty_cache()


def _scan_in_place(torch, params, cfg, h_in, strat):
    """(device us a call, launches) of ssd_chunk_scan in one CudaBackend
    forward of the canvas (a decode step's work), from a profiler window."""
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer

    before = _lib.launch_counts()["ssd_chunk_scan"]
    with new_profiler(torch) as prof:
        transformer.forward_hidden(params, cfg, h_in,
                                   strategy=strat.with_backend("cuda"))
        torch.cuda.synchronize()
    n = _lib.launch_counts()["ssd_chunk_scan"] - before
    us = sum(device_us(prof, "ssd_chunk_").values())
    assert n > 0, "ssd_chunk_scan never launched in the forward"
    return us / n, n


def mamba_main_path(torch):
    """Phase 11: Mamba2-370m (48 SSD layers, bf16, random weights), B=4,
    prompt 3840 + gen 256 (N = 4096), DecodeSession.run with the config's
    NoCache, the confidence scheduler and CudaBackend for MAMBA_STEPS steps
    (two ssd_chunk_scan launches a layer a step, hidden states finite),
    then a profiled window.  Returns the launches of the run (prefill and
    steps)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.strategy import NoCache
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer

    cfg = get_arch("mamba2-370m")
    b, n = MAMBA["B"], MAMBA["N"]
    p_len = n - MAMBA_GEN
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"  init {cfg.name} bf16 weights ({cfg.param_count() / 1e9:.3f} B "
          f"parameters): {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator().manual_seed(17)
    prompt = torch.randint(0, cfg.vocab_size - 1, (b, p_len), generator=gen)

    _lib.reset_launch_counts()
    sess = DecodeSession(params, cfg, backend="cuda")
    assert isinstance(sess.strategy, NoCache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.prefill(prompt, MAMBA_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    at_prefill = _lib.launch_counts()["ssd_chunk_scan"]
    t0 = time.perf_counter()
    _, info = sess.run(MAMBA_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = _lib.launch_counts()
    steps = info["steps"]
    assert steps == MAMBA_STEPS, f"mamba2 ran {steps} steps"
    assert bool(sess.last_info["row_finite"].all()), "non-finite hidden"
    per_step = (launches["ssd_chunk_scan"] - at_prefill) / steps
    assert per_step == 2 * cfg.n_layers, \
        f"{per_step} ssd_chunk_scan launches a step"
    committed = int((sess.state.tokens[:, p_len:] != cfg.mask_id).sum())
    ms = t_run / steps * 1e3
    print(f"  NoCache: prefill {t_prefill:.4f} s ({at_prefill} launches: "
          f"a cache-less prefill builds the canvas only), {steps} steps in "
          f"{t_run:.3f} s, {ms:.2f} ms/step, committed {committed} of "
          f"{b * MAMBA_GEN} slots, {committed / t_run:.1f} generated "
          f"tokens/s; ssd_chunk_scan launches a step {per_step:.0f}")
    profile_steps(torch, sess.step, 3, "mamba2 NoCache")
    del sess, params
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the baselines
# ---------------------------------------------------------------------------

FULL_BASELINES = ("value", "singular_incremental")
ROUNDS, BLOCK = 3, 8      # interleaved comparison: rounds of 8-step blocks


def baselines(torch, cfg, params, proxies, spa):
    """The main path's decode (LLaDA-8B bf16, B=4, prompt 256 + gen 256,
    CudaBackend) under each baseline strategy: a warm-up step, a profiled
    window of 4 steps, then the timed part (to completion for
    ``FULL_BASELINES``, else ``BASELINE_STEPS`` steps).  Then every
    strategy and ``spa`` side by side (``interleaved``).  Returns the
    launches of the whole phase."""
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.kernels import _lib

    gen = torch.Generator().manual_seed(11)
    b, p_len = 4, 256
    prompt = torch.randint(0, cfg.vocab_size - 1, (b, p_len), generator=gen)
    _lib.reset_launch_counts()
    summary = []
    for name, strat in baseline_strategies(cfg).items():
        before = _lib.launch_counts()
        sess = DecodeSession(
            params, cfg, strategy=strat, backend="cuda",
            spa_proxies=proxies if strat.uses_proxy_mat else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sess.prefill(prompt, GEN_LEN)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
        sess.step()
        profile_steps(torch, sess.step, 4, name)
        open_before = int(sess.state.n_masked.sum())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name in FULL_BASELINES:
            steps = sess.run()[1]["steps"]
            assert int(sess.state.n_masked.max()) == 0, \
                f"{name}: n_masked not drained"
            assert int((sess.tokens[:, p_len:] == cfg.mask_id).sum()) == 0, \
                f"{name}: open slots remain"
        else:
            for _ in range(BASELINE_STEPS):
                sess.step()
            steps = BASELINE_STEPS
        torch.cuda.synchronize()
        t_run = time.perf_counter() - t0
        assert bool(sess.last_info["row_finite"].all()), \
            f"{name}: non-finite hidden states"
        generated = open_before - int(sess.state.n_masked.sum())
        after = _lib.launch_counts()
        delta = {k: after[k] - before[k] for k in after
                 if after[k] > before[k]}
        for k in BASELINE_NEEDS[name]:
            assert delta.get(k, 0) > 0, f"{name}: kernel {k} never launched"
        ms = t_run / steps * 1e3
        summary.append((name, steps, ms, generated / t_run))
        print(f"  {name}: prefill {t_prefill:.3f} s, {steps} timed steps, "
              f"{ms:.2f} ms/step, {generated / t_run:.1f} generated "
              f"tokens/s; launches {delta}")
        del sess
        torch.cuda.empty_cache()
    print("  summary (ms/step, generated tokens/s): " + "; ".join(
        f"{n} {ms:.2f}, {tps:.1f}" for n, _, ms, tps in summary))
    interleaved(torch, cfg, params, proxies, prompt,
                dict(singular=spa, **baseline_strategies(cfg)))
    return _lib.launch_counts()


def interleaved(torch, cfg, params, proxies, prompt, strategies):
    """Wall ms/step of every strategy, comparable within the call: the
    host-bound step drifts over a run by more than the strategies differ,
    so all sessions live side by side and step in ``ROUNDS`` rounds of one
    ``BLOCK``-step block each, the order rotating from round to round;
    a strategy's figure is the median of its blocks' mean ms/step (each
    step syncs on ``done``, as ``run`` does)."""
    from repro_torch.dlm.session import DecodeSession

    sess = {}
    for name, strat in strategies.items():
        sess[name] = DecodeSession(
            params, cfg, strategy=strat, backend="cuda",
            spa_proxies=proxies if strat.uses_proxy_mat else None)
        sess[name].prefill(prompt, GEN_LEN)
        sess[name].step()
    names = list(sess)
    times = {name: [] for name in names}
    for i in range(ROUNDS):
        shift = i * len(names) // ROUNDS
        for name in names[shift:] + names[:shift]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(BLOCK):
                assert not sess[name].done
                sess[name].step()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / BLOCK * 1e3)
    base = statistics.median(times["singular"])
    print(f"  interleaved, {ROUNDS} rounds of {BLOCK}-step blocks, order "
          f"rotating (median ms/step, blocks' range, / singular):")
    for name in names:
        med = statistics.median(times[name])
        print(f"    {name:>20}: {med:7.2f} ({min(times[name]):.2f}-"
              f"{max(times[name]):.2f}), {med / base:.2f}x")
    del sess
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 7: the server at full width
# ---------------------------------------------------------------------------

def paging_cost(torch, cfg, params, strat, proxies, pairs: int = 10,
                block: int = 8):
    """What paging costs a step: the main path's decode (B=4, prompt 256 +
    gen 256, full-length rows, kv_len given to both) on a dense cache and
    on a pool of pages of 16.  Both sessions live side by side and step in
    ``pairs`` pairs of ``block``-step blocks, the order alternating pair by
    pair; a block's time is its mean ms/step (each step syncs on ``done``,
    as ``run`` does).  The host-bound step varies a lot from block to
    block, so only the paired comparison says anything."""
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.serving.pool import PagePool

    gen = torch.Generator().manual_seed(11)
    b, p_len = 4, 256
    n = p_len + GEN_LEN
    prompt = torch.randint(0, cfg.vocab_size - 1, (b, p_len), generator=gen)
    kv_len = torch.full((b,), n, dtype=torch.int32)
    pool = PagePool(cfg, n_pages=1 + b * (n // PAGE), page_size=PAGE,
                    strategy=strat)
    pt = torch.tensor([pool.page_table_row(pool.alloc(n // PAGE), n)
                       for _ in range(b)])
    sess = {}
    for kind in ("dense", "paged"):
        sess[kind] = DecodeSession(params, cfg, strategy=strat,
                                   backend="cuda", spa_proxies=proxies)
        paged = kind == "paged"
        sess[kind].prefill(prompt, GEN_LEN, kv_len=kv_len,
                           arenas=pool.arenas_for(strat) if paged else None,
                           page_table=pt if paged else None)
        sess[kind].step()
    times = {"dense": [], "paged": []}
    for i in range(pairs):
        for kind in (("dense", "paged") if i % 2 == 0
                     else ("paged", "dense")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(block):
                assert not sess[kind].done
                sess[kind].step()
            torch.cuda.synchronize()
            times[kind].append((time.perf_counter() - t0) / block * 1e3)
    assert torch.equal(sess["dense"].state.tokens,
                       sess["paged"].state.tokens), \
        "paged and dense sessions diverged"
    slower = sum(p > d for d, p in zip(times["dense"], times["paged"]))
    diff = [p - d for d, p in zip(times["dense"], times["paged"])]

    def spread(xs):
        q = statistics.quantiles(xs, n=4)
        return (f"median {statistics.median(xs):.2f} (quartiles {q[0]:.2f}"
                f"-{q[2]:.2f}, range {min(xs):.2f}-{max(xs):.2f})")

    print(f"  paging A/B, {pairs} pairs of {block}-step blocks in "
          f"alternating order (ms/step): dense {spread(times['dense'])}; "
          f"paged {spread(times['paged'])}; paged - dense per pair "
          f"{spread(diff)}; paged slower in {slower} of {pairs} pairs; "
          f"tokens identical")
    del sess, pool


# (prompt, gen) of the queued requests: 160 pages of 16 rows, 1.67x the pool
SERVE_REQUESTS = ((128, 128), (64, 64), (256, 256), (192, 192), (128, 256),
                  (64, 64), (256, 128), (192, 192))
LATE_REQUEST = (256, 256)     # priority 5, submitted at engine step 32
LATE_STEP = 32
PROFILE_WINDOW = (60, 64)     # engine steps after which the trace starts/ends


def serve_full_width(torch, cfg, params, strat, proxies, *, device=None,
                     profile: bool = True):
    """LLaDA-8B through ``ServingEngine``: canvas 512, pages of 16 rows, a
    pool of 97 pages (96 allocatable: three full canvases), 4 slots,
    ``run(max_steps=300)``; eight requests queued up front and one of
    priority 5 arriving at engine step 32, which must preempt.  Reuses the
    main path's weights and SVD proxies."""
    import numpy as np
    from repro_torch.kernels import _lib
    from repro_torch.serving.engine import ServingEngine

    engine = ServingEngine(cfg, params, max_batch=4, canvas_len=SLICE["N"],
                           strategy=strat, pool_pages=97, page_size=PAGE,
                           device=device)
    engine._proxies[engine.strategy] = proxies   # no second SVD
    rng = np.random.default_rng(0)
    for p_len, g_len in SERVE_REQUESTS:
        engine.submit(rng.integers(0, cfg.vocab_size - 1, p_len), g_len)
    late_prompt = rng.integers(0, cfg.vocab_size - 1, LATE_REQUEST[0])
    marks = {}                  # engine step -> host clock after it
    seen = {"released_row": False}
    prof = new_profiler(torch) if profile else None

    def on_step(e):
        step = e.stats.steps
        marks[step] = time.perf_counter()
        sess = next(iter(e._sessions.values()))
        assert bool(sess.last_info["row_finite"].all()), \
            f"non-finite hidden states at engine step {step}"
        seen["released_row"] |= int(sess.state.kv_len.min()) == 0
        if step == LATE_STEP:
            e.submit(late_prompt, LATE_REQUEST[1], priority=5)
        if prof is not None and step in PROFILE_WINDOW:
            torch.cuda.synchronize()
            if step == PROFILE_WINDOW[0]:
                prof.start()
                seen["t0"] = time.perf_counter()
            else:
                prof.stop()
                seen["wall_us"] = (time.perf_counter() - seen["t0"]) * 1e6

    _lib.reset_launch_counts()
    stats = engine.run(max_steps=300, on_step=on_step)
    launches = _lib.launch_counts()
    n_req = len(SERVE_REQUESTS) + 1
    assert stats.requests_done == n_req == len(engine.done), \
        f"{stats.requests_done} of {n_req} requests completed"
    for r in engine.done:
        assert r.output is not None and len(r.output) == r.gen_len
        assert not (r.output == cfg.mask_id).any(), f"uid {r.uid}: open slots"
    assert stats.preemptions >= 1, "the priority-5 arrival preempted nothing"
    assert engine.pool.available == engine.pool.capacity, "pool not drained"
    assert seen["released_row"], "no released row (kv_len 0) was stepped"
    wall = engine._wall
    intervals = [marks[i] - marks[i - 1] for i in marks
                 if i - 1 in marks and not (
                     prof is not None
                     and PROFILE_WINDOW[0] < i <= PROFILE_WINDOW[1])]
    gen_tokens = sum(r.gen_len for r in engine.done)
    pct = stats.percentiles()
    print(f"  engine steps {stats.steps}, swaps {stats.swaps}, preemptions "
          f"{stats.preemptions}, admission stalls {stats.admission_stalls}")
    print(f"  pool: peak {stats.peak_pool_util:.1%}, steady "
          f"{stats.steady_pool_util:.1%} of {engine.pool.capacity} pages")
    print(f"  wall {wall:.3f} s, {gen_tokens} generated tokens, "
          f"{stats.tokens_committed / wall:.1f} generated tokens/s, "
          f"{wall / stats.steps * 1e3:.2f} ms per engine step "
          f"(median step-to-step {statistics.median(intervals) * 1e3:.2f} "
          f"ms outside the profiled window)")
    print(f"  e2e p50 {pct['e2e_p50']:.3f} s, p95 {pct['e2e_p95']:.3f} s")
    print(f"  launches on the serving path: {launches}")
    if prof is not None:
        report_profile(prof, PROFILE_WINDOW[1] - PROFILE_WINDOW[0],
                       seen["wall_us"], "engine")
    return launches


# (prompt, gen) of each drift lane's requests: 65 pages, 5 requests, 4 slots
DRIFT_LANE_REQUESTS = ((128, 64), (64, 32), (256, 96), (192, 64), (96, 48))
DRIFT_LANES = ("attn_in", "singular_incremental", "attn_out")
DRIFT_PROFILE = ("attn_in", (10, 14))   # lane and engine steps profiled


def serve_drift_lanes(torch, cfg, params, proxies):
    """Paged lanes of the identifiers that score through
    ``cosine_drift_paged``: ``ServingEngine`` (canvas 512, 97 pages of 16,
    4 slots, continuous batching) serves five mixed-length requests under
    each of ``DRIFT_LANES``; all complete, outputs have no open slot, the
    hidden states stay finite, the pool drains and each lane launched
    ``cosine_drift_paged``, with a ``torch.profiler`` window over a few
    engine steps of the ``DRIFT_PROFILE`` lane (cosine_drift_paged in
    place).  Returns the launches of the whole phase."""
    import numpy as np
    from repro_torch.kernels import _lib
    from repro_torch.serving.engine import ServingEngine

    strats = baseline_strategies(cfg)
    _lib.reset_launch_counts()
    for name in DRIFT_LANES:
        strat = strats[name]
        before = _lib.launch_counts()
        engine = ServingEngine(cfg, params, max_batch=4,
                               canvas_len=SLICE["N"], strategy=strat,
                               pool_pages=97, page_size=PAGE)
        if strat.uses_proxy_mat:
            engine._proxies[engine.strategy] = proxies   # no second SVD
        rng = np.random.default_rng(1)
        for p_len, g_len in DRIFT_LANE_REQUESTS:
            engine.submit(rng.integers(0, cfg.vocab_size - 1, p_len), g_len)

        window = DRIFT_PROFILE[1] if name == DRIFT_PROFILE[0] else ()
        prof = new_profiler(torch) if window else None
        seen = {}

        def on_step(e):
            sess = next(iter(e._sessions.values()))
            assert bool(sess.last_info["row_finite"].all()), \
                f"{name}: non-finite hidden states at step {e.stats.steps}"
            if e.stats.steps in window:
                torch.cuda.synchronize()
                if e.stats.steps == window[0]:
                    prof.start()
                    seen["t0"] = time.perf_counter()
                else:
                    prof.stop()
                    seen["wall_us"] = (time.perf_counter() - seen["t0"]) * 1e6

        t0 = time.perf_counter()
        stats = engine.run(max_steps=300, on_step=on_step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if window:
            assert "wall_us" in seen, f"{name}: the profiled window never ran"
            report_profile(prof, window[1] - window[0], seen["wall_us"],
                           f"{name} lane engine")
        assert stats.requests_done == len(DRIFT_LANE_REQUESTS), \
            f"{name}: {stats.requests_done} requests completed"
        for r in engine.done:
            assert len(r.output) == r.gen_len
            assert not (r.output == cfg.mask_id).any(), \
                f"{name} uid {r.uid}: open slots"
        assert engine.pool.available == engine.pool.capacity, \
            f"{name}: pool not drained"
        after = _lib.launch_counts()
        n_drift = after["cosine_drift_paged"] - before["cosine_drift_paged"]
        assert n_drift > 0, f"{name}: cosine_drift_paged never launched"
        print(f"  {name}: {stats.steps} engine steps, {stats.swaps} swaps, "
              f"{stats.tokens_committed / wall:.1f} generated tokens/s, "
              f"{wall / stats.steps * 1e3:.2f} ms per engine step, "
              f"cosine_drift_paged launches {n_drift}")
        del engine
        torch.cuda.empty_cache()
    return _lib.launch_counts()


# ---------------------------------------------------------------------------
# Phase 12: shared-prefix serving (the prefix index, copy-on-write pages and
# the suffix-only prefill) through ServingEngine
# ---------------------------------------------------------------------------

# 12(a): 2-layer full-width f32 LLaDA; prompts of a 32-token system prompt
# (2 pages) and one of 3 questions of 8 tokens, each asked twice; gen 16,
# canvas 64 (4 pages), 2 slots
PREFIX_SMALL = dict(system=32, question=8, questions=3, gen=16, canvas=64,
                    slots=2)
# 12(b): LLaDA-8B, canvas 512, 4 slots; a 224-token system prompt (14
# pages) and 6 questions of 32 tokens, each asked twice, gen 256 (the JAX
# package's shared-system-prompt traffic, benchmarks/bench_serving.py)
PREFIX_FULL = dict(system=224, question=32, questions=6, gen=256,
                   canvas=512, slots=4)
PREFIX_POOL = 257         # 4 rows of 32 pages + the index's 122 + slack
PREFIX_WARM_STEPS = 8     # the untimed warm pass stops each request here
PREFIX_PROBE_STEPS = 2    # the probed pass stops each request here
# bf16 suffix rows over the cold prefix K/V against a cold prefill: the two
# differ in GEMM shapes (288 against 512 rows a request), so cuBLAS may
# round differently; the limit phase 4 holds bf16 prefill caches to
PREFIX_BF16_TOL = 2.0 ** -5
PREFIX_PROFILE = (300, 304)   # engine steps profiled: wave 2, all decode


def shared_prompt_traffic(cfg, system: int, question: int, questions: int,
                          seed: int):
    """One system prompt followed by each question, each question asked
    twice (q0 .. q{n-1}, then the same again)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab_size - 1, system)
    qs = [rng.integers(0, cfg.vocab_size - 1, question)
          for _ in range(questions)]
    return [np.concatenate([head, qs[i % questions]]).astype(np.int32)
            for i in range(2 * questions)]


class AdmissionProbe:
    """Watches the port's admissions while it is entered, through four
    seams.  ``DecodeSession._paged_fill`` (every paged admission): its
    rows' kinds, from the ``SharedPrefix`` specs it is given; the query
    counts ``sparse_attention`` should see (one call a layer for each
    suffix start of its cold and partial rows, over the suffix only); the
    counts it saw and the launches counted meanwhile; the fill's device
    time.  ``core.cache.copy_arena_pages`` (publication and copy-on-write):
    the pages moved and the copy's device time.  ``prefill_partial``:
    its inputs and output.  ``sparse_attention``: the query count of each
    call inside a fill.  With ``snapshot``, the source of every page a
    copy writes is kept, as it was before the copy, and each page a hit
    attaches must equal it bit for bit."""

    def __init__(self, torch, snapshot: bool = False):
        self.torch = torch
        self.snapshot = snapshot
        self.fills = []          # (kinds, expected kq, seen kq, launches,
        #                           start event, end event)
        self.copies = []         # (pages, start event, end event)
        self.written = {}        # page -> {kind: {name: tensor}}: what the
        #                           last copy into it read
        self.partials = []       # (tokens, kv_view, s0, kv_len, output)
        self._kq = None

    def _event(self):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __enter__(self):
        from repro_torch.core import cache
        from repro_torch.dlm import decoding
        from repro_torch.dlm.session import DecodeSession
        from repro_torch.kernels import _lib
        from repro_torch.kernels import sparse_attention as sa
        probe, torch = self, self.torch
        self._saved = [
            (DecodeSession, "_paged_fill", DecodeSession._paged_fill),
            (cache, "copy_arena_pages", cache.copy_arena_pages),
            (decoding, "prefill_partial", decoding.prefill_partial),
            (sa, "sparse_attention", sa.sparse_attention)]
        orig = {n: f for _, n, f in self._saved}

        def paged_fill(sess, arenas, tokens, extras, kv_len, read_pt,
                       shared):
            m, n = tokens.shape
            page = n // read_pt.shape[1]
            kv = kv_len.tolist() if kv_len is not None else [n] * m
            s0 = {s.row: len(s.pages) * page for s in shared}
            kinds = ["cold" if r not in s0 else
                     "full" if s0[r] >= kv[r] else "partial"
                     for r in range(m)]
            starts = sorted({s0.get(r, 0) for r in range(m)
                             if kinds[r] != "full"})
            expected = [n - st for st in starts
                        for _ in range(sess.cfg.n_layers)]
            if probe.snapshot:
                for s in shared:
                    for p in s.pages:
                        for kind, bufs in arenas.items():
                            for nm, t in bufs.items():
                                assert torch.equal(
                                    t[:, p], probe.written[p][kind][nm]), \
                                    f"attached page {p} {nm} differs from " \
                                    "the page it was copied from"
            probe._kq = []
            before = _lib.launch_counts()["sparse_attention"]
            start = probe._event()
            try:
                orig["_paged_fill"](sess, arenas, tokens, extras, kv_len,
                                    read_pt, shared)
            finally:
                seen, probe._kq = probe._kq, None
            probe.fills.append((
                kinds, expected, seen,
                _lib.launch_counts()["sparse_attention"] - before,
                start, probe._event()))

        def copy_pages(arenas, src, dst):
            if probe.snapshot:      # the source pages, before the copy
                for sp, p in zip(src, dst):
                    probe.written[int(p)] = {
                        kind: {nm: t[:, int(sp)].clone()
                               for nm, t in bufs.items()}
                        for kind, bufs in arenas.items()}
            start = probe._event()
            out = orig["copy_arena_pages"](arenas, src, dst)
            probe.copies.append((len(dst), start, probe._event()))
            return out

        def prefill_partial(params, cfg, inputs, kv_view, s0, **kw):
            out = orig["prefill_partial"](params, cfg, inputs, kv_view, s0,
                                          **kw)
            if probe.snapshot:
                probe.partials.append((
                    inputs["tokens"].clone(),
                    {k: {nm: t.clone() for nm, t in b.items()}
                     for k, b in kv_view.items()},
                    s0, kw.get("kv_len"), out))
            return out

        def attention(q, *a, **kw):
            if probe._kq is not None:
                probe._kq.append(q.shape[1])
            return orig["sparse_attention"](q, *a, **kw)

        DecodeSession._paged_fill = paged_fill
        cache.copy_arena_pages = copy_pages
        decoding.prefill_partial = prefill_partial
        sa.sparse_attention = attention
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)
        return False

    def check_fills(self) -> None:
        """Every admission launched ``sparse_attention`` exactly for its
        cold and partial rows' suffixes, and never for full hits."""
        for kinds, expected, seen, launched, *_ in self.fills:
            assert seen == expected and launched == len(expected), \
                f"admission {kinds}: sparse_attention kq {seen}, launches " \
                f"{launched}, expected kq {expected}"

    def check_index(self, engine) -> int:
        """The index pages still equal the copies that published them.
        Returns how many there are."""
        pages = engine.prefix.device_pages()
        arenas = engine.pool.arenas_for(engine.strategy)
        for p in pages:
            for kind, bufs in arenas.items():
                for nm, t in bufs.items():
                    assert self.torch.equal(t[:, p],
                                            self.written[p][kind][nm]), \
                        f"index page {p} {nm} changed after publication"
        return len(pages)


def suffix_diff(part, cold, s0) -> float:
    """Largest difference of the suffix rows [s0:) of a partial prefill's
    cache from a cold prefill's, over each buffer's largest value."""
    worst = 0.0
    for kind, bufs in part.items():
        for nm, t in bufs.items():
            w = cold[kind][nm][:, :, s0:]
            worst = max(worst, max_err(t[:, :, s0:], w)
                        / max(float(w.float().abs().max()), 1e-30))
    return worst


def partial_vs_cold(torch, params, cfg, proxies, strat, partials):
    """For each recorded partial prefill: its suffix rows against a cold
    prefill of the same rows, over the published prefix pages it read and
    over the cold prefill's own prefix K/V.  Returns the two largest
    differences (see ``suffix_diff``)."""
    from repro_torch.dlm import decoding
    stale = exact = 0.0
    for tokens, kv_view, s0, kv_len, part in partials:
        _, cold = decoding.prefill(params, cfg, {"tokens": tokens}, proxies,
                                   strat, kv_len=kv_len)
        stale = max(stale, suffix_diff(part, cold, s0))
        own = decoding.prefill_partial(
            params, cfg, {"tokens": tokens},
            {kind: {nm: bufs[nm] for nm in ("k", "v")}
             for kind, bufs in cold.items()}, s0, kv_len=kv_len,
            spa_proxies=proxies, strategy=strat)
        exact = max(exact, suffix_diff(own, cold, s0))
        del cold, own
    return stale, exact


def full_hit_agreement(on, off) -> str:
    """How many hits of the prefix-on run decode the prefix-off tokens.
    ``on``/``off``: the finished requests in submission order.  A full hit
    is a cold prefill's bits only where one request published its whole
    run: the repeats of the first request's prompt; the other repeats take
    the system prompt's pages from that request."""
    first = on[0].prompt
    hits = [i for i, r in enumerate(on) if r.shared_n]
    full = [i for i in hits if on[i].shared_full]
    own = {i for i in full if (on[i].prompt == first).all()}
    same = {i for i in hits if (on[i].output == off[i].output).all()}
    return (f"{len(same & own)} of {len(own)} full hits on one publisher's "
            f"run, {len(same & set(full)) - len(same & own)} of "
            f"{len(full) - len(own)} on a run of two publishers, "
            f"{len(same - set(full))} of {len(hits) - len(full)} partial "
            f"hits")


def prefix_parity(torch):
    """Phase 12(a): a 2-layer, full-width f32 LLaDA through
    ``ServingEngine`` with the prefix index on and off, on the same
    requests.  Asserts that every page a hit attaches equals, bit for bit,
    the publisher's prefill-time page it was copied from (and the index
    pages still do after the run); that an admission launches
    ``sparse_attention`` once per layer for each group of cold or partial
    rows, over a partial row's suffix only, and never for a full hit; that
    there were full and partial hits; and that a suffix-only prefill over
    the cold prefill's prefix K/V gives the cold prefill's suffix rows
    within 1e-5 of each buffer's largest value.  Prints that difference,
    the one over the published prefix pages, and how many hits decode the
    tokens of the prefix-off engine."""
    from repro_torch.serving.engine import ServingEngine

    cfg, params, strat, proxies, _ = _parity_setup(torch, "float32")
    c = PREFIX_SMALL
    prompts = shared_prompt_traffic(cfg, c["system"], c["question"],
                                    c["questions"], seed=5)
    n_log = c["canvas"] // PAGE
    out = {}
    for prefix in (False, True):
        engine = ServingEngine(cfg, params, max_batch=c["slots"],
                               canvas_len=c["canvas"], strategy=strat,
                               pool_pages=1 + 8 * n_log, page_size=PAGE,
                               prefix_cache=prefix)
        engine._proxies[engine.strategy] = proxies
        for p in prompts:
            engine.submit(p, c["gen"])
        with AdmissionProbe(torch, snapshot=prefix) as probe:
            engine.run()
        torch.cuda.synchronize()
        assert engine.stats.requests_done == len(prompts)
        for r in engine.done:
            assert not (r.output == cfg.mask_id).any(), f"uid {r.uid}"
        probe.check_fills()
        out[prefix] = sorted(engine.done, key=lambda r: r.uid)
    st = engine.stats
    assert st.prefix_full_hits > 0 and st.prefix_hits > st.prefix_full_hits, \
        f"hits {st.prefix_hits}, full {st.prefix_full_hits}"
    assert engine.pool.used == engine.prefix.held_pages
    n_index = probe.check_index(engine)
    shared = [k for k, *_ in probe.fills if set(k) != {"cold"}]
    full_only = sum(set(k) == {"full"} for k in shared)
    assert full_only > 0, "no admission of full hits alone"
    # the engine's partial prefills read prefix pages a request with
    # another question published (bidirectional layers: stale from layer
    # 2 on); the same suffix prefill over the cold prefill's own prefix
    # K/V must match the cold prefill's suffix rows
    stale, exact = partial_vs_cold(torch, params, cfg, proxies, strat,
                                   probe.partials)
    print(f"  prefix on: {st.prefix_hits} hits ({st.prefix_full_hits} full),"
          f" {st.prefix_tokens_saved} prefill rows saved, "
          f"{st.prefix_published} pages published; {len(probe.written)} "
          f"copied pages and {n_index} index pages bitwise their sources")
    print(f"  admissions with shared pages: {len(shared)} ({full_only} of full"
          f" hits alone: 0 sparse_attention launches); partial groups "
          f"launch it once a layer over the suffix (kq {c['canvas']} - s0)")
    print(f"  suffix rows of {len(probe.partials)} partial prefills, "
          f"largest difference from a cold prefill of the same rows (of the "
          f"buffer's largest value): {exact:.3e} over the cold prefix K/V, "
          f"{stale:.3e} over the published prefix pages (another question's"
          f" canvas)")
    print(f"  tokens equal to prefix off: "
          f"{full_hit_agreement(out[True], out[False])}")
    assert exact <= 1e-5, f"suffix rows differ by {exact}"
    del params, proxies


def prefix_serving(torch, cfg, params, strat, proxies):
    """Phase 12(b): LLaDA-8B through ``ServingEngine`` (canvas 512, pages of
    16, 4 slots, a pool of ``PREFIX_POOL`` pages) on the shared-system-prompt
    traffic, with the prefix index off and on: an untimed warm pass of the
    same requests cut at ``PREFIX_WARM_STEPS`` steps each, then (index
    dropped) the timed pass, which nothing instruments.  Every request must
    finish with no [MASK] left.  Prints hits, engine ms per step (mean, and
    median step to step outside the profiled window), TTFT and e2e
    percentiles, generated tokens/s, a ``torch.profiler`` window over
    engine steps ``PREFIX_PROFILE`` (device ms a step, busy share), and how
    many hits decode the prefix-off tokens.  Then ``probed_admissions``."""
    from repro_torch.serving.engine import ServingEngine

    c = PREFIX_FULL
    prompts = shared_prompt_traffic(cfg, c["system"], c["question"],
                                    c["questions"], seed=7)
    out = {}
    for prefix in (False, True):
        engine = ServingEngine(cfg, params, max_batch=c["slots"],
                               canvas_len=c["canvas"], strategy=strat,
                               pool_pages=PREFIX_POOL, page_size=PAGE,
                               prefix_cache=prefix)
        engine._proxies[engine.strategy] = proxies
        for p in prompts:
            engine.submit(p, c["gen"])
        engine.run(max_steps=PREFIX_WARM_STEPS)
        engine.done.clear()
        engine.stats = type(engine.stats)()
        engine.pool.reset_telemetry()
        engine.drop_prefix_cache()
        for p in prompts:
            engine.submit(p, c["gen"])
        prof, marks, seen = new_profiler(torch), {}, {}

        def on_step(e):
            step = e.stats.steps
            marks[step] = time.perf_counter()
            if step in PREFIX_PROFILE:
                torch.cuda.synchronize()
                if step == PREFIX_PROFILE[0]:
                    prof.start()
                    seen["t0"] = time.perf_counter()
                else:
                    prof.stop()
                    seen["wall_us"] = (time.perf_counter() - seen["t0"]) * 1e6

        torch.cuda.synchronize()
        stats = engine.run(max_steps=2 * c["gen"], on_step=on_step)
        torch.cuda.synchronize()
        assert stats.requests_done == len(prompts) == len(engine.done)
        for r in engine.done:
            assert len(r.output) == c["gen"]
            assert not (r.output == cfg.mask_id).any(), f"uid {r.uid}: open"
        held = engine.prefix.held_pages if prefix else 0
        assert engine.pool.used == held, "pool not drained to the index"
        out[prefix] = sorted(engine.done, key=lambda r: r.uid)
        wall = engine._wall
        pct = stats.percentiles()
        label = "prefix on" if prefix else "prefix off"
        if prefix:
            print(f"  {label}: {stats.prefix_hits} hits "
                  f"({stats.prefix_full_hits} full), "
                  f"{stats.prefix_tokens_saved} prefill rows saved, "
                  f"{stats.prefix_published} pages published "
                  f"({stats.prefix_publish_skipped} skipped), {held} held")
        intervals = [marks[i] - marks[i - 1] for i in marks
                     if i - 1 in marks and not (
                         PREFIX_PROFILE[0] < i <= PREFIX_PROFILE[1])]
        print(f"  {label}: {stats.steps} engine steps, "
              f"{wall / stats.steps * 1e3:.2f} ms per engine step (median "
              f"{statistics.median(intervals) * 1e3:.2f} step to step), "
              f"{stats.tokens_committed / wall:.1f} generated tokens/s, "
              f"TTFT p50 {pct['ttft_p50']:.3f} s p95 {pct['ttft_p95']:.3f} s,"
              f" e2e p50 {pct['e2e_p50']:.3f} s p95 {pct['e2e_p95']:.3f} s")
        assert "wall_us" in seen, f"{label}: the profiled window never ran"
        report_profile(prof, PREFIX_PROFILE[1] - PREFIX_PROFILE[0],
                       seen["wall_us"], f"{label} engine")
        if not prefix:
            del engine
            torch.cuda.empty_cache()
    print(f"  tokens equal to prefix off: "
          f"{full_hit_agreement(out[True], out[False])}")
    probed_admissions(torch, engine, prompts, cfg, params, strat, proxies)
    del engine
    torch.cuda.empty_cache()


def probed_admissions(torch, engine, prompts, cfg, params, strat, proxies):
    """Phase 12(b), the probed pass: the prefix-on engine serves the same
    requests again (index dropped), each cut at ``PREFIX_PROBE_STEPS``
    steps so that all three admission waves run in a few steps, under an
    ``AdmissionProbe`` with snapshots.  Asserts the timed pass's hits; that
    every admission launched ``sparse_attention`` for its cold and partial
    rows' suffixes only (none for full hits); that every page a hit
    attaches, and every index page afterwards, equals bit for bit the page
    it was copied from; and that the suffix rows of a partial prefill, run
    over the cold prefill's own prefix K/V, are within
    ``PREFIX_BF16_TOL`` of a cold bf16 prefill of the same rows (of each
    buffer's largest value).  Prints each admission's fill (device ms by
    CUDA events) and the page copies' device ms a page."""
    want = engine.stats
    engine.done.clear()
    engine.stats = type(engine.stats)()
    engine.drop_prefix_cache()
    for p in prompts:
        engine.submit(p, PREFIX_FULL["gen"])
    with AdmissionProbe(torch, snapshot=True) as probe:
        engine.run(max_steps=PREFIX_PROBE_STEPS)
    torch.cuda.synchronize()
    st = engine.stats
    keys = ("prefix_hits", "prefix_full_hits", "prefix_tokens_saved",
            "prefix_published")
    assert [getattr(st, k) for k in keys] == \
        [getattr(want, k) for k in keys], \
        f"probed pass {[getattr(st, k) for k in keys]}, timed pass " \
        f"{[getattr(want, k) for k in keys]}"
    probe.check_fills()
    n_index = probe.check_index(engine)
    kinds = {frozenset(k) for k, *_ in probe.fills}
    assert {frozenset({"cold"}), frozenset({"full"})} <= kinds and any(
        "partial" in k for k in kinds), f"admission kinds {kinds}"
    parts = []
    for k, _, _, launched, start, end in probe.fills:
        rows = ", ".join(f"{k.count(x)} {x}" for x in
                         ("cold", "partial", "full") if x in k)
        parts.append(f"{rows}: {start.elapsed_time(end):.3f} ms "
                     f"({launched} launches)")
    print(f"  probed pass ({PREFIX_PROBE_STEPS} steps a request): admission "
          f"fills, device ms: {'; '.join(parts)}")
    pages = sum(n for n, *_ in probe.copies)
    copy_ms = sum(a.elapsed_time(b) for n, a, b in probe.copies if n)
    print(f"  page copies (publication and copy-on-write): {pages} pages in "
          f"{sum(1 for n, *_ in probe.copies if n)} calls, "
          f"{copy_ms / max(pages, 1):.4f} ms a page; a full hit's "
          f"admission is its fill plus "
          f"{PREFIX_FULL['canvas'] // PAGE} pages of copy-on-write")
    print(f"  {len(probe.written)} copied pages and {n_index} index pages "
          f"bitwise their sources")
    stale, exact = partial_vs_cold(torch, params, cfg, proxies, strat,
                                   probe.partials)
    print(f"  suffix rows of {len(probe.partials)} partial prefills "
          f"({cfg.param_dtype}), "
          f"largest difference from a cold prefill of the same rows (of the "
          f"buffer's largest value): {exact:.3e} over the cold prefix K/V "
          f"(limit {PREFIX_BF16_TOL:g}), {stale:.3e} over the published "
          f"prefix pages")
    assert exact <= PREFIX_BF16_TOL, f"suffix rows differ by {exact}"
    del probe


# ---------------------------------------------------------------------------
# Phase 13: the dense configs at full width (Dream-7B, Gemma2-2B,
# H2O-Danube3-4B, DeepSeek-67B cut by depth)
# ---------------------------------------------------------------------------

# name, layers run (DeepSeek-67B: 16 of 95, about 25 GB in bf16), batch,
# prompt (the windowed models fill their 8192-token context)
DENSE = (("dream-7b", 28, 4, 256), ("gemma2-2b", 26, 2, 8192 - 256),
         ("h2o-danube-3-4b", 24, 2, 8192 - 256), ("deepseek-67b", 16, 4, 256))
DENSE_GEN = 256
DENSE_SPA_STEPS = 16
DENSE_NOCACHE_STEPS = 4
DENSE_KERNELS = ("proxy_score", "gather_norm", "sparse_attention",
                 "scatter_update_multi")


def attention_key(cfg) -> str:
    """The launch count a bf16 decode step's attention adds to: the int8
    body's where the cache is int8."""
    return ("sparse_attention_int8" if cfg.cache_dtype == "int8"
            else "sparse_attention")


def _dense_setup(torch, name: str, dtype: str):
    """A 2-layer, full-width copy of a dense config (Gemma2: one local and
    one global layer), its proxies and a prompt: B=2 of 8192 - 16 rows for
    the windowed models (the window masks keys), else B=4 of 48."""
    from repro_torch.configs import get_arch
    from repro_torch.core.strategy import SPACache
    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_arch(name), n_layers=2, param_dtype=dtype)
    params = transformer.init_params(cfg, seed=7)
    strat = SPACache.from_spec(cfg.spa)
    proxies = strat.build_proxies(params, cfg)
    windowed = any(transformer.layer_window(cfg, k) for k in cfg.layer_kinds)
    b, p_len = (2, 8192 - 16) if windowed else (4, 48)
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size - 1, (b, p_len), generator=gen)
    return cfg, params, strat, proxies, prompt


def dense_parity(torch, name: str):
    """A dense config at 2 layers and full width through ``CudaBackend`` and
    ``TorchBackend``: f32 free-running (identical tokens; an int8 cache's
    codes within 1 and its f16 scales within 2^-10 of their largest value,
    other buffers within 1e-5), bf16 in lockstep within 2^-5."""
    setup = _dense_setup(torch, name, "float32")
    quantized = setup[0].cache_dtype == "int8"
    decode_parity(torch, 1e-5, setup, setup[2], f"{name} singular",
                  quantized=quantized)
    del setup
    torch.cuda.empty_cache()
    setup = _dense_setup(torch, name, "bfloat16")
    lockstep_parity(torch, 2 ** -5, 2 ** -5, setup, setup[2],
                    f"{name} singular")
    del setup
    torch.cuda.empty_cache()


class WindowProbe:
    """While entered, records the query positions of every windowed
    ``sparse_attention`` call, to count the (query, key) pairs its window
    masks."""

    def __init__(self):
        self.calls = []          # (q_pos [B, kq], n keys, window)

    def __enter__(self):
        from repro_torch.kernels import sparse_attention as sa
        self._orig = sa.sparse_attention
        probe = self

        def attention(q, k, v, q_pos, **kw):
            if kw.get("window", 0) > 0:
                probe.calls.append((q_pos.clone(), k.shape[1], kw["window"]))
            return probe._orig(q, k, v, q_pos, **kw)

        sa.sparse_attention = attention
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import sparse_attention as sa
        sa.sparse_attention = self._orig

    def masked_pairs(self):
        """(masked pairs, all pairs) over the recorded calls (every row's
        keys valid: the decode runs full-length rows)."""
        masked = total = 0
        for pos, n, window in self.calls:
            p = pos.long()
            lo = (p - window).clamp(min=0)
            hi = (p + window).clamp(max=n - 1)
            masked += int((n - (hi - lo + 1)).sum())
            total += pos.numel() * n
        return masked, total


def dense_main_path(torch, name: str, layers: int, b: int, p_len: int):
    """Phase 13, one config: random bf16 weights (``layers`` of its depth),
    its own ``spa``, ``DecodeSession`` with ``CudaBackend`` and the
    confidence scheduler, B = ``b``, prompt ``p_len`` + gen 256:
    ``DENSE_SPA_STEPS`` SPA steps, then ``DENSE_NOCACHE_STEPS`` NoCache
    steps.  Asserts finite hidden states, every kernel of the path
    launched, the dense attention grid once a layer at prefill and a step
    (no banded call: at 8192 rows a window of 4096 leaves no band), and for
    windowed models a step whose windows mask some (query, key) pairs.
    Prints ms a step, device ms and busy share over 4 SPA steps, the
    per-layer k and launches a step."""
    from repro_torch.configs import get_arch
    from repro_torch.core import spa_layer
    from repro_torch.core.strategy import NoCache, SPACache
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer

    full = get_arch(name)
    cfg = dataclasses.replace(full, n_layers=layers)
    n = p_len + DENSE_GEN
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0)
    strat = SPACache.from_spec(cfg.spa)
    proxies = strat.build_proxies(params, cfg)
    torch.cuda.synchronize()
    windowed = sorted({k for k in cfg.layer_kinds
                       if transformer.layer_window(cfg, k)})
    print(f"  {name}: {layers} of {full.n_layers} layers "
          f"({cfg.param_count() / 1e9:.2f} B parameters, bf16, cache "
          f"{cfg.cache_dtype}), d={cfg.d_model}, {cfg.n_heads} q heads on "
          f"{cfg.n_kv_heads} kv heads of {cfg.head_dim}, r={cfg.spa.rank}, "
          f"B={b}, N={n}"
          + (f", window {cfg.window} on {windowed}" if windowed else "")
          + f"; weights and proxies {time.perf_counter() - t0:.2f} s")
    print(f"    per-layer k: {spa_layer.layer_ks(cfg, strat, n)}")
    gen = torch.Generator().manual_seed(17)
    prompt = torch.randint(0, cfg.vocab_size - 1, (b, p_len), generator=gen)

    _lib.reset_launch_counts()
    sess = DecodeSession(params, cfg, strategy=strat, backend="cuda",
                         spa_proxies=proxies)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sess.prefill(prompt, DENSE_GEN)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    at_prefill = _lib.launch_counts()
    t0 = time.perf_counter()
    _, info = sess.run(DENSE_SPA_STEPS)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    launches = _lib.launch_counts()
    steps = info["steps"]
    assert steps == DENSE_SPA_STEPS, f"{name} ran {steps} steps"
    assert bool(sess.last_info["row_finite"].all()), f"{name}: non-finite"
    for kname in DENSE_KERNELS:
        assert launches[kname] > 0, f"{name}: kernel {kname} never launched"
    per_step = {k: (launches[k] - at_prefill[k]) / steps
                for k in launches if launches[k]}
    # prefill attends over its fresh bf16 K/V; a step over the cache,
    # through the int8 body where the cache is int8
    step_key = attention_key(cfg)
    assert at_prefill["sparse_attention"] == layers, at_prefill
    assert per_step[step_key] == layers, per_step
    assert sum(per_step.get(k, 0) for k in ("sparse_attention",
                                             "sparse_attention_int8")) \
        == layers, per_step
    assert launches["sparse_attention_banded"] == 0, "a banded grid ran"
    committed = int((sess.state.tokens[:, p_len:] != cfg.mask_id).sum())
    spa_ms = t_run / steps * 1e3
    print(f"    SPA: prefill {t_prefill:.3f} s, {steps} steps in "
          f"{t_run:.3f} s, {spa_ms:.2f} ms/step; committed {committed} of "
          f"{b * DENSE_GEN} slots")
    print(f"    launches at prefill: "
          f"{ {k: at_prefill[k] for k in at_prefill if at_prefill[k]} }; per "
          f"step: {per_step}; attention: the dense grid, {layers} calls at "
          f"prefill and a step ({step_key}), no banded call")
    if windowed:
        with WindowProbe() as probe:
            sess.step()
        masked, total = probe.masked_pairs()
        print(f"    one step's windowed attention: {len(probe.calls)} calls,"
              f" {masked} of {total} (query, key) pairs masked by the "
              f"window")
        assert masked > 0, f"{name}: the window masked nothing"
    spa_wall, spa_dev = profile_steps(torch, sess.step, 4, f"{name} SPA")
    del sess
    torch.cuda.empty_cache()

    base = DecodeSession(params, cfg, strategy=NoCache(), backend="cuda")
    base.prefill(prompt, DENSE_GEN, use_cache=False)
    base.step()
    torch.cuda.synchronize()
    before = _lib.launch_counts()
    t0 = time.perf_counter()
    for _ in range(DENSE_NOCACHE_STEPS):
        base.step()
    torch.cuda.synchronize()
    base_ms = (time.perf_counter() - t0) / DENSE_NOCACHE_STEPS * 1e3
    attn = (_lib.launch_counts()["sparse_attention"]
            - before["sparse_attention"]) / DENSE_NOCACHE_STEPS
    assert attn == layers, f"{name} NoCache: {attn} attention calls a step"
    assert bool(base.last_info["row_finite"].all())
    print(f"    NoCache: {base_ms:.2f} ms/step over {DENSE_NOCACHE_STEPS} "
          f"steps ({attn:g} dense-grid attention calls a step, kq = N); "
          f"SPA/NoCache wall {spa_ms / base_ms:.3f}"
          + (f"; SPA device {spa_dev:.2f} ms/step" if spa_dev else ""))
    del base, params, proxies
    torch.cuda.empty_cache()
    return launches


def dense_configs(torch) -> dict:
    """Phase 13: for each dense config its 2-layer parity, then its main
    path; the weights are freed between configs.  Returns the launches of
    ``INT8_CONFIG``'s main path (the int8 K/V attention's record)."""
    int8_launches = {}
    for name, layers, b, p_len in DENSE:
        t0 = time.perf_counter()
        print(f"  {name}: 2-layer full-width parity (CudaBackend vs "
              "TorchBackend)")
        dense_parity(torch, name)
        launches = dense_main_path(torch, name, layers, b, p_len)
        if name == INT8_CONFIG:
            int8_launches = launches
        print(f"    {name}: {time.perf_counter() - t0:.1f} s")
    return int8_launches


# ---------------------------------------------------------------------------
# Phase 14: the host-RAM page tier under the prefix index, at full width
# ---------------------------------------------------------------------------

# the JAX serving benchmark's host-tier traffic (benchmarks/bench_serving.py:
# _hier_workload, seed 29) scaled x16 in tokens: 8 distinct requests of
# prompt 64-176 and gen 64-256, in waves of 2 slots drained in between; a
# canvas of 512 and 60 pages of 16 (the bench's 15 pages of 4 at canvas 32)
HIER = dict(requests=8, slots=2, canvas=512, pool=60, scale=16)
HIER_STEPS = 16           # engine steps a request (publication is at admission)
HIER_RUNS = (("tier off", None), ("tier on, f32", "f32"),
             ("tier on, auto", "auto"))
# 14(a): 2-layer full-width f32 LLaDA, canvas 64, pages of 16, 2 slots
HIER_SMALL = dict(canvas=64, prompt=40, gen=16, slots=2, pool=13)


def hier_traffic(cfg, scale: int):
    """The JAX bench's ``_hier_workload`` draws, lengths times ``scale``."""
    import numpy as np
    rng = np.random.default_rng(29)
    out = []
    for _ in range(HIER["requests"]):
        p_len = int(rng.integers(4, 12)) * scale
        gen = int(rng.integers(4, 17)) * scale
        out.append((rng.integers(0, cfg.vocab_size - 1, p_len)
                    .astype(np.int32), gen))
    return out


def hier_waves(engine, reqs, slots: int, max_steps: int):
    for i in range(0, len(reqs), slots):
        for prompt, gen in reqs[i:i + slots]:
            engine.submit(prompt, gen)
        engine.run(max_steps=max_steps)


def hier_reset(engine):
    engine.done.clear()
    engine.stats = type(engine.stats)()
    engine.pool.reset_telemetry()
    if engine.host_pool is not None:
        engine.host_pool.reset_telemetry()


class TierProbe:
    """While entered, times the host tier's stages: per demotion and
    promotion (``TierManager.demote`` / ``promote``, which set the current
    operation), the growth of the pinned arenas (``HostPagePool._entry``),
    the copies (``HostPagePool.store`` into pinned slots, with its wait,
    its growth included; ``HostPagePool.load`` out of them; the engine's
    arena write), the checksums and the int8 quantization (and
    dequantization).  Host
    time from ``perf_counter``; device time from CUDA events around each
    stage, read when the probe closes."""

    STAGES = ("alloc", "copy", "checksum", "quantize")

    def __init__(self, torch):
        self.torch = torch
        self.op = None
        self.host = {}           # (op, stage) -> seconds
        self.events = []         # (op, stage, start, end)
        self.bytes = {"demotion": 0, "promotion": 0}
        self.ops = {"demotion": 0, "promotion": 0}
        self.pages = {"demotion": 0, "promotion": 0}

    def _wrap(self, stage, fn, count_bytes=None):
        probe, torch = self, self.torch

        def wrapper(*a, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            key = (probe.op, stage)
            probe.host[key] = probe.host.get(key, 0.0) + (
                time.perf_counter() - t0)
            end.record()
            probe.events.append((probe.op, stage, start, end))
            if count_bytes is not None:
                probe.bytes[probe.op] += count_bytes(a, kw, out)
            return out

        return wrapper

    def _op(self, name, fn):
        probe = self

        def wrapper(tier, refs_or_pages, *a, **kw):
            outer, probe.op = probe.op, name
            try:
                out = probe._wrap("total", fn)(tier, refs_or_pages, *a, **kw)
            finally:
                probe.op = outer
            if name == "promotion" or out is not None:
                probe.ops[name] += 1
                probe.pages[name] += len(refs_or_pages)
            return out

        return wrapper

    def __enter__(self):
        from repro_torch.serving import hier
        from repro_torch.serving.engine import ServingEngine

        def nbytes(blocks):
            return sum(t.numel() * t.element_size()
                       for bufs in blocks.values() for t in bufs.values())

        self._saved = [
            (hier.HostPagePool, "store", hier.HostPagePool.store),
            (hier.HostPagePool, "_entry", hier.HostPagePool._entry),
            (hier.HostPagePool, "load", hier.HostPagePool.load),
            (hier.HostPagePool, "checksum", hier.HostPagePool.checksum),
            (hier, "_quantize_blocks", hier._quantize_blocks),
            (hier, "_dequantize_blocks", hier._dequantize_blocks),
            (hier.TierManager, "demote", hier.TierManager.demote),
            (hier.TierManager, "promote", hier.TierManager.promote),
            (ServingEngine, "_tier_write", ServingEngine._tier_write)]
        o = {n: f for _, n, f in self._saved}
        hier.HostPagePool.store = self._wrap(
            "copy", o["store"], lambda a, kw, out: nbytes(a[4]))
        hier.HostPagePool.load = self._wrap(
            "copy", o["load"], lambda a, kw, out: nbytes(out))
        hier.HostPagePool.checksum = self._wrap("checksum", o["checksum"])
        hier.HostPagePool._entry = self._wrap("alloc", o["_entry"])
        hier._quantize_blocks = self._wrap("quantize", o["_quantize_blocks"])
        hier._dequantize_blocks = self._wrap("quantize",
                                             o["_dequantize_blocks"])
        hier.TierManager.demote = self._op("demotion", o["demote"])
        hier.TierManager.promote = self._op("promotion", o["promote"])
        probe = self

        def tier_write(engine, sig, pages, blocks):
            outer, probe.op = probe.op, "promotion"
            try:
                return probe._wrap("copy", o["_tier_write"])(
                    engine, sig, pages, blocks)
            finally:
                probe.op = outer

        ServingEngine._tier_write = tier_write
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._saved:
            setattr(owner, name, fn)

    def report(self, label: str) -> None:
        self.torch.cuda.synchronize()
        dev = {}
        for op, stage, start, end in self.events:
            dev[(op, stage)] = dev.get((op, stage), 0.0) + \
                start.elapsed_time(end)
        for op in ("demotion", "promotion"):
            if not self.ops[op]:
                print(f"    {label}: no {op}")
                continue
            n = self.ops[op]
            parts = ", ".join(
                f"{stage} {self.host.get((op, stage), 0.0) * 1e3 / n:.3f} / "
                f"{dev.get((op, stage), 0.0) / n:.3f}"
                for stage in self.STAGES)
            copy_ms = dev.get((op, "copy"), 0.0) - dev.get((op, "alloc"), 0.0)
            rate = (self.bytes[op] / (copy_ms * 1e-3) / 1e9
                    if copy_ms > 0 else 0.0)
            print(f"    {label}: {n} {op}s of {self.pages[op]} pages "
                  f"({self.bytes[op] / 1e6:.1f} MB through the host tier); "
                  f"ms a {op}, host / device: total "
                  f"{self.host.get((op, 'total'), 0.0) * 1e3 / n:.3f} / "
                  f"{dev.get((op, 'total'), 0.0) / n:.3f}, {parts} (copy "
                  f"includes alloc and, for a promotion, the arena write); "
                  f"copies {rate:.2f} GB/s")


def hier_serving(torch, cfg, params, strat, proxies):
    """Phase 14(b): LLaDA-8B through ``ServingEngine(prefix_cache=True)``
    on the host-tier traffic (``HIER``), each request cut at
    ``HIER_STEPS`` steps: for the tier off, on at f32 and on at auto, a
    warm pass, then (statistics reset, as the JAX bench does) a measured
    pass under ``TierProbe``.  Prints hits and full hits, pages evicted,
    demoted, dropped and promoted, promotions and stalls, peak host use,
    each demotion's and promotion's stages and ms per engine step.
    Asserts more full hits with the tier on than off, and both tiers
    holding exactly what the index refers to."""
    from repro_torch.serving.engine import ServingEngine

    c = HIER
    reqs = hier_traffic(cfg, c["scale"])
    host_pages = sum(-(-(len(p) + g) // PAGE) for p, g in reqs)
    print(f"  traffic: {len(reqs)} requests, prompts "
          f"{sorted(len(p) for p, _ in reqs)}, gens "
          f"{sorted(g for _, g in reqs)}; prefix set {host_pages} pages, "
          f"pool {c['pool']} pages of {PAGE} rows "
          f"({cfg.n_layers * PAGE * (3 * cfg.d_model + cfg.spa.rank) * 2 / 1e6:.1f}"
          f" MB a page), {c['slots']} slots")
    full = {}
    for label, host_dtype in HIER_RUNS:
        engine = ServingEngine(
            cfg, params, max_batch=c["slots"], canvas_len=c["canvas"],
            strategy=strat, pool_pages=c["pool"], page_size=PAGE,
            prefix_cache=True, host_pages=host_pages if host_dtype else 0,
            host_dtype=host_dtype or "auto")
        engine._proxies[engine.strategy] = proxies
        if engine.host_pool is not None:
            assert engine.host_pool.pin, "host arenas not pinned"
        hier_waves(engine, reqs, c["slots"], HIER_STEPS)
        warm = engine.stats
        hier_reset(engine)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with TierProbe(torch) as probe:
            hier_waves(engine, reqs, c["slots"], HIER_STEPS)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = engine.stats
        assert st.requests_done == len(reqs)
        assert engine.pool.used == engine.prefix.held_pages, "pool leak"
        if engine.host_pool is not None:
            assert (engine.host_pool.used_pages
                    == engine.prefix.host_held_pages), "host tier leak"
        full[label] = st.prefix_full_hits
        print(f"  {label}: {st.prefix_hits} hits ({st.prefix_full_hits} "
              f"full), {st.prefix_evicted_pages} pages evicted, "
              f"{st.prefix_demoted_pages} demoted, {st.prefix_dropped_pages}"
              f" dropped, {st.prefix_promoted_pages} promoted in "
              f"{st.prefix_promotions} promotions ({st.promotion_stalls} "
              f"stalls), peak host use {st.peak_host_util:.3f}; "
              f"{st.steps} engine steps, {wall / st.steps * 1e3:.2f} ms per "
              f"engine step (warm pass: {warm.prefix_full_hits} full hits, "
              f"{warm.prefix_demoted_pages} pages demoted, "
              f"{warm.prefix_promoted_pages} promoted)")
        probe.report(label)
        del engine
        torch.cuda.empty_cache()
    assert full["tier on, f32"] > full["tier off"], full
    assert full["tier on, auto"] > full["tier off"], full


def hier_exactness(torch):
    """Phase 14(a): a 2-layer, full-width f32 LLaDA through ``ServingEngine``
    (canvas 64, pages of 16, 2 slots, a pool of 13 pages, the host tier at
    f32): four requests published alone, two more admitted together (their
    admission evicts, so index entries demote), then the first two again.
    Asserts: every page an f32 promotion writes equals, bit for bit, what
    its demotion read; the repeats decode the tokens of an engine whose
    pool never evicts; an int8 round trip of index pages on the card stays
    within max|row|/254 plus the f16 scale's cast; with every host slot
    corrupted before the repeats, promotions raise ``HostPageCorruption``
    and are served cold with the same tokens, and after a drain both tiers
    hold exactly what the index refers to and ``drop_prefix_cache`` empties
    both."""
    import numpy as np
    from repro_torch.core import cache as cache_lib
    from repro_torch.serving import hier
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.pool import cache_signature

    cfg, params, strat, proxies, _ = _parity_setup(torch, "float32")
    c = HIER_SMALL
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size - 1, c["prompt"])
               .astype(np.int32) for _ in range(4)]
    waves = [[0], [1], [2, 3], [0], [1]]

    def serve(pool, host_pages, corrupt=False, watch=False):
        engine = ServingEngine(cfg, params, max_batch=c["slots"],
                               canvas_len=c["canvas"], strategy=strat,
                               pool_pages=pool, page_size=PAGE,
                               prefix_cache=True, host_pages=host_pages,
                               host_dtype="f32")
        engine._proxies[engine.strategy] = proxies
        checked = []
        if watch:
            tier = engine.tier
            read, demote, promote = tier.read_pages, tier.demote, tier.promote
            last, saved = {}, {}

            def read_pages(sig, pages):
                blocks = read(sig, pages)
                last["b"] = {k: {n: t.clone() for n, t in b.items()}
                             for k, b in blocks.items()}
                return blocks

            def demote_(pages, exact_in=True):
                refs = demote(pages, exact_in)
                for i, r in enumerate(refs or ()):
                    saved[r] = {k: {n: t[:, i] for n, t in b.items()}
                                for k, b in last["b"].items()}
                return refs

            def promote_(refs):
                sig, blocks = promote(refs)
                for i, r in enumerate(refs):
                    for k, bufs in saved.pop(r).items():
                        for n, want in bufs.items():
                            assert torch.equal(blocks[k][n][:, i], want), \
                                f"promoted {k}/{n} differs"
                            checked.append(n)
                return sig, blocks

            tier.read_pages, tier.demote, tier.promote = (
                read_pages, demote_, promote_)
        for i, wave in enumerate(waves):
            if corrupt and i == 3:
                refs = engine.prefix._host_refs()
                assert refs, "nothing demoted before the repeats"
                for r in refs:
                    engine.host_pool.corrupt_slot(r.sig, r.repr_, r.slot)
            for j in wave:
                engine.submit(prompts[j], c["gen"])
            engine.run()
        torch.cuda.synchronize()
        outs = [r.output for r in sorted(engine.done, key=lambda r: r.uid)]
        return engine, outs, checked

    n_log = c["canvas"] // PAGE
    ref, ref_out, _ = serve(1 + 16 * n_log, 0)
    st = ref.stats
    assert st.prefix_evicted_pages == 0 and st.prefix_full_hits == 2, st
    tiered, out, checked = serve(c["pool"], 4 * n_log, watch=True)
    st = tiered.stats
    print(f"  tiered (pool {c['pool']}): {st.prefix_hits} hits "
          f"({st.prefix_full_hits} full), {st.prefix_demoted_pages} pages "
          f"demoted, {st.prefix_promoted_pages} promoted; {len(checked)} "
          f"promoted buffers bitwise what their demotion read")
    assert st.prefix_promotions > 0 and checked, "no promotion"
    assert st.prefix_full_hits == 2, st
    same = sum(int((a == b).all()) for a, b in zip(out, ref_out))
    print(f"  tokens equal to the never-evicting engine: {same} of "
          f"{len(out)} requests")
    assert same == len(out), "a promoted full hit decoded other tokens"
    assert tiered.pool.used == tiered.prefix.held_pages
    assert tiered.host_pool.used_pages == tiered.prefix.host_held_pages

    # int8 round trip of the never-evicting engine's index pages, on the card
    sig = cache_signature(cfg, ref.strategy)
    arenas = ref.pool.peek_arenas(sig)
    pages = ref.prefix.device_pages()[:4]
    orig = cache_lib.read_arena_pages(arenas, pages)
    tier8 = hier.TierManager(
        hier.HostPagePool(8, device="cuda"), host_dtype="int8",
        read_pages=lambda s, p: cache_lib.read_arena_pages(arenas, p),
        device="cuda")
    tier8.note_published(sig, pages, None)
    refs = tier8.demote(pages)
    assert refs and all(r.repr_ == "int8" and not r.exact for r in refs)
    _, back = tier8.promote(refs)
    worst = 0.0
    for kind, bufs in orig.items():
        for name, x in bufs.items():
            xf = x.float()
            scale = torch.clamp(xf.abs().amax(-1, keepdim=True) / 127.0,
                                min=1e-8)
            bound = (scale * 0.5 + 127 * torch.clamp(scale * 2.0 ** -11,
                                                     min=2.0 ** -24) + 1e-7)
            err = (back[kind][name].float() - xf).abs()
            assert bool((err <= bound).all()), f"int8 {kind}/{name}"
            worst = max(worst, float((err / bound).max()))
    print(f"  int8 round trip of {len(pages)} index pages: largest error "
          f"{worst:.3f} of its bound (max|row|/254 + the f16 scale's cast)")

    bad, bad_out, _ = serve(c["pool"], 4 * n_log, corrupt=True)
    st = bad.stats
    same = sum(int((a == b).all()) for a, b in zip(bad_out, ref_out))
    print(f"  corrupted host slots: {st.host_checksum_failures} checksum "
          f"failures, {st.cold_prefill_fallbacks} served cold, "
          f"{st.prefix_promotions} promotions; tokens equal to the "
          f"never-evicting engine: {same} of {len(bad_out)}")
    assert st.host_checksum_failures > 0
    assert st.cold_prefill_fallbacks == st.host_checksum_failures
    assert same == len(bad_out), "a cold fallback decoded other tokens"
    assert bad.pool.used == bad.prefix.held_pages, "pool leak"
    assert bad.host_pool.used_pages == bad.prefix.host_held_pages
    bad.drop_prefix_cache()
    assert bad.pool.used == 0 and bad.host_pool.used_pages == 0
    assert bad.host_pool.used_units == 0
    del ref, tiered, bad, params, proxies
    torch.cuda.empty_cache()


# Phase 15: online serving.  15(a) runs the JAX serving bench's online part
# (``benchmarks/bench_serving.py``, part 3) at its own shape on a 2-layer
# f32 LLaDA; 15(b) the same Poisson trace x16 in tokens and virtual time on
# LLaDA-8B; 15(c) an HTTP front end on the real clock.
ONLINE_SMALL = dict(canvas=32, page=4, slots=4, n=12)
# 15(b) serves the first 7 of the trace's 12 requests (two passes of 440
# steps): the fewest at which the SLO-aware pass preempts, by phase 15(b)'s
# functions on the CPU at 2 reduced layers (with 6 or fewer the two passes
# decode alike); all 12 take two passes of ~700 steps
ONLINE_FULL = dict(canvas=512, pool=130, slots=4, n=7, scale=16)
ONLINE_POLICY = dict(boost=2, urgency_frac=0.6)
# 15(c): (prompt, gen) of the clients, interactive and batch at x16
ONLINE_HTTP = ((96, 96), (128, 256), (96, 96), (96, 96), (128, 256),
               (96, 96))
ONLINE_HTTP_STAGGER = 0.2     # seconds between client submissions
ONLINE_HTTP_DROP = 0          # this client hangs up after its first token


def online_classes(cfg, rng, scale: int = 1):
    """The JAX bench's ``_online_classes``, lengths and SLO targets times
    ``scale``: interactive (60%) prompt 6 + gen 6, TTFT 8, deadline 60;
    batch prompt 8 + gen 16, deadline 400 (virtual seconds = steps)."""
    import numpy as np
    from repro_torch.serving.slo import SLO
    interactive = (6 * scale, 6 * scale, SLO(ttft=8.0 * scale,
                                             deadline=60.0 * scale))
    batch = (8 * scale, 16 * scale, SLO(deadline=400.0 * scale))

    def draw(i):
        p_len, gen, slo = interactive if rng.random() < 0.6 else batch
        return (i, rng.integers(0, cfg.vocab_size - 1, p_len)
                .astype(np.int32), gen, slo)
    return draw


def poisson_arrivals(cfg, n: int, rate: float, seed: int = 11,
                     scale: int = 1):
    """The JAX bench's ``_poisson_arrivals``: exponential gaps at ``rate``
    requests a step; (time, index, prompt, gen, SLO) tuples."""
    import numpy as np
    rng = np.random.default_rng(seed)
    draw = online_classes(cfg, rng, scale)
    t, out = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        out.append((t,) + draw(i))
    return out


def bursty_arrivals(cfg, n: int, burst: int, gap: float, seed: int = 13):
    """The JAX bench's ``_bursty_arrivals``: ``burst`` requests together
    every ``gap`` steps."""
    import numpy as np
    rng = np.random.default_rng(seed)
    draw = online_classes(cfg, rng)
    return [(float((i // burst) * gap),) + draw(i) for i in range(n)]


def serve_arrivals(engine, clock, arrivals, warm: bool):
    """The JAX bench's ``_serve_online`` on ``engine`` (whose clock is the
    ``StepClock`` ``clock``): with ``warm``, first serve four of the
    trace's prompts untimed and reset the statistics; then feed each
    arrival once the clock reaches it, one tick an engine step, idle gaps
    jumping to the next arrival.  Every request streams.  Returns (events,
    uid -> trace index, wall seconds)."""
    if warm:
        for _, _, prompt, gen, _ in arrivals[:2] + arrivals[-2:]:
            engine.submit(prompt, gen)
        engine.run()
        engine.done.clear()
        engine.stats = type(engine.stats)()
        engine.pool.reset_telemetry()
        clock.t = 0.0
    events, index = [], {}
    engine.event_sink = events.append
    pending = sorted(arrivals, key=lambda a: (a[0], a[1]))

    def feed(e):
        while pending and pending[0][0] <= clock.t + 1e-9:
            _, i, prompt, gen, slo = pending.pop(0)
            index[e.submit(prompt, gen, slo=slo, stream=True)] = i

    def on_step(e):
        clock.advance()
        feed(e)

    t0 = time.perf_counter()
    feed(engine)
    while True:
        engine.run(max_steps=100_000, on_step=on_step)
        if not pending:
            break
        clock.t = max(clock.t, pending[0][0])
        feed(engine)
    return events, index, time.perf_counter() - t0


def online_metrics(engine, clock, index) -> dict:
    """The JAX bench's per-pass metrics, and the completed outputs by trace
    index."""
    import math
    outputs, n_ttft, late = {}, 0, 0
    for r in engine.done:
        if r.output is not None and not (r.shed or r.canceled):
            outputs[index[r.uid]] = r.output.tobytes()
        if r.slo is not None and math.isfinite(r.slo.ttft):
            n_ttft += 1
            late += int(r.first_token_at is None
                        or r.first_token_at - r.submitted_at > r.slo.ttft)
    st = engine.stats
    pct = st.percentiles()
    return dict(completed=len(outputs), shed=st.requests_shed,
                preemptions=st.preemptions,
                boosted=sum(bool(r.boosted) for r in engine.done),
                steps=st.steps,
                virtual=clock.t, slo_met=st.slo_met,
                slo_missed=st.slo_missed, goodput=st.goodput(clock.t),
                ttft_miss=late / max(n_ttft, 1), outputs=outputs, **pct)


def stream_key(ev):
    return (ev.kind, ev.uid, ev.step, tuple(ev.positions), tuple(ev.tokens))


def check_streams(engine, events) -> int:
    """Every completed request's token events cover each gen position
    exactly once and equal its output; returns the requests checked."""
    import numpy as np
    by_uid = {}
    for ev in events:
        if ev.kind == "token":
            by_uid.setdefault(ev.uid, []).append(ev)
    n = 0
    for r in engine.done:
        if r.output is None:
            continue
        pos = [p for ev in by_uid.get(r.uid, ()) for p in ev.positions]
        tok = [t for ev in by_uid.get(r.uid, ()) for t in ev.tokens]
        assert sorted(pos) == list(range(r.gen_len)), \
            f"uid {r.uid}: streamed positions {sorted(pos)[:8]}..."
        got = np.zeros(r.gen_len, np.int64)
        got[pos] = tok
        assert (got == r.output).all(), f"uid {r.uid}: stream != output"
        n += 1
    return n


def online_line(label: str, m: dict, wall: float) -> str:
    return (f"  {label}: {m['completed']} completed, {m['shed']} shed, "
            f"{m['boosted']} boosted, {m['preemptions']} preemptions, "
            f"{m['steps']} steps "
            f"({m['virtual']:.0f} virtual), SLO {m['slo_met']} met / "
            f"{m['slo_missed']} missed, goodput {m['goodput']:.4f} a step, "
            f"TTFT misses {m['ttft_miss']:.0%}, TTFT p50/p95 "
            f"{m['ttft_p50']:.1f}/{m['ttft_p95']:.1f} steps, TPOT p50/p95 "
            f"{m['tpot_p50']:.2f}/{m['tpot_p95']:.2f} steps, "
            f"{wall / max(m['steps'], 1) * 1e3:.2f} wall ms an engine step")


def online_exactness(torch):
    """Phase 15(a): a 2-layer, full-width f32 LLaDA through ``ServingEngine``
    at the JAX bench's online shape (canvas 32, pages of 4, a pool of 4
    canvases + 2, 4 slots, prefix index on, ``SPACache`` with
    ``refresh_interval=1``, ``StepClock(tick=1)``) on its Poisson and
    bursty traces, FIFO and ``SLOPolicy(boost=2, urgency_frac=0.6)``, each
    pass through ``CudaBackend`` and ``TorchBackend``.  Asserts identical
    event streams and shed sets across the backends, byte-identical
    outputs of every request both passes complete, SLO-aware goodput at
    least FIFO's, and tracing with ``dynamics_every=1`` changing no
    event."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slo import SLOPolicy, StepClock
    from repro_torch.serving.telemetry import Telemetry

    cfg, params, strat, proxies, _ = _parity_setup(torch, "float32")
    strat = dataclasses.replace(strat, refresh_interval=1)
    c = ONLINE_SMALL

    def serve(arrivals, aware, backend, telemetry=None):
        clock = StepClock(tick=1.0)
        engine = ServingEngine(
            cfg, params, max_batch=c["slots"], canvas_len=c["canvas"],
            strategy=strat.with_backend(backend), page_size=c["page"],
            pool_pages=c["slots"] * (c["canvas"] // c["page"]) + 2,
            prefix_cache=True, clock=clock, telemetry=telemetry,
            slo_policy=SLOPolicy(**ONLINE_POLICY) if aware else None)
        engine._proxies[engine.strategy] = proxies
        events, index, wall = serve_arrivals(engine, clock, arrivals,
                                             warm=True)
        m = online_metrics(engine, clock, index)
        check_streams(engine, events)
        assert engine.pool.used == engine.prefix.held_pages, "pool leak"
        return engine, [stream_key(ev) for ev in events], m, wall

    traces = (("poisson", poisson_arrivals(cfg, c["n"], rate=0.5)),
              ("bursty", bursty_arrivals(cfg, c["n"], burst=12, gap=12.0)))
    kept = {}
    for name, arrivals in traces:
        runs = kept[name] = {}
        for aware in (False, True):
            cuda = serve(arrivals, aware, "cuda")
            plain = serve(arrivals, aware, "torch")
            assert cuda[1] == plain[1], \
                f"{name}: event streams differ across the backends"
            shed = [{r.uid for r in run[0].done if r.shed}
                    for run in (cuda, plain)]
            assert shed[0] == shed[1], f"{name}: shed sets differ"
            runs[aware] = cuda
            print(online_line(f"{name} {'SLO-aware' if aware else 'FIFO'}",
                              cuda[2], cuda[3])
                  + f"; {len(cuda[1])} events, as TorchBackend's")
        off, on = runs[False][2], runs[True][2]
        common = sorted(set(off["outputs"]) & set(on["outputs"]))
        same = sum(off["outputs"][i] == on["outputs"][i] for i in common)
        print(f"  {name}: {same} of {len(common)} requests both passes "
              f"complete decode byte-identically; goodput FIFO "
              f"{off['goodput']:.4f}, SLO-aware {on['goodput']:.4f}")
        assert same == len(common), f"{name}: completed outputs diverged"
        assert on["goodput"] >= off["goodput"], f"{name}: goodput fell"
    traced = serve(traces[0][1], True, "cuda",
                   Telemetry.enabled(dynamics_every=1))
    assert traced[1] == kept["poisson"][True][1], \
        "tracing changed the event stream"
    tr = traced[0].telemetry.tracer
    assert tr.open_spans() == []
    print(f"  traced SLO-aware poisson pass (dynamics_every=1): the same "
          f"{len(traced[1])} events; {len(tr.events)} trace events")
    del params, proxies
    torch.cuda.empty_cache()


ENGINE_PHASES = ("dispatch", "host_overlap", "host_sync")


def phase_samples(engine) -> dict:
    """The engine-phase span histograms' retained samples (seconds)."""
    reg = engine.telemetry.registry
    return {ph: reg.histogram("spa_engine_phase_seconds",
                              labels={"phase": ph}).samples
            for ph in ENGINE_PHASES}


def phase_medians_ms(engine, since: dict = None) -> str:
    """Median ms of each engine-phase span, over the samples after the
    counts in ``since`` (phase -> samples already taken)."""
    return ", ".join(
        f"{ph} {statistics.median(xs[(since or {}).get(ph, 0):]) * 1e3:.2f}"
        for ph, xs in phase_samples(engine).items())


class GcPauses:
    """Host time spent in the garbage collector while entered (through
    ``gc.callbacks``): collections, full (generation 2) collections and
    their total seconds."""

    def __init__(self):
        self.count = self.full = 0
        self.seconds = 0.0
        self._t = None

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        elif self._t is not None:
            self.seconds += time.perf_counter() - self._t
            self.count += 1
            self.full += int(info["generation"] == 2)
            self._t = None

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def line(self) -> str:
        return (f"gc {self.count} collections ({self.full} full), "
                f"{self.seconds * 1e3:.1f} ms")


def online_full_width(torch, cfg, params, strat, proxies):
    """Phase 15(b): LLaDA-8B through ``ServingEngine`` (canvas 512, pool
    130 pages of 16, 4 slots, prefix index on, the config's SPA with
    ``refresh_interval=1``) on the JAX bench's Poisson trace x16 in tokens
    and virtual time (its first ``ONLINE_FULL["n"]`` requests at 0.5 / 16
    a step, seed 11), one FIFO
    and one SLO-aware pass under a ``StepClock``, tracer on the wall
    clock.  Asserts that every completed stream covers each gen position
    once and equals its output, that the pool drains to the index's pages,
    that the serving kernels launched and that the SLO-aware pass boosted,
    preempted or shed at least once.  Prints each pass's counts, goodput,
    TTFT / TPOT percentiles in steps, wall ms an engine step, the
    engine-phase span medians and the garbage collector's pauses, and how
    many completed outputs the two passes share byte for byte."""
    from repro_torch.kernels import _lib
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slo import SLOPolicy, StepClock
    from repro_torch.serving.telemetry import Telemetry

    c = ONLINE_FULL
    arrivals = poisson_arrivals(cfg, c["n"], rate=0.5 / c["scale"],
                                scale=c["scale"])
    print(f"  trace: {len(arrivals)} requests over "
          f"{arrivals[-1][0]:.0f} virtual steps, gens "
          f"{[a[3] for a in arrivals]}")
    strat = dataclasses.replace(strat, refresh_interval=1)
    outs = {}
    _lib.reset_launch_counts()
    for aware in (False, True):
        clock = StepClock(tick=1.0)
        engine = ServingEngine(
            cfg, params, max_batch=c["slots"], canvas_len=c["canvas"],
            strategy=strat, pool_pages=c["pool"], page_size=PAGE,
            prefix_cache=True, clock=clock,
            telemetry=Telemetry.enabled(dynamics_every=0),
            slo_policy=SLOPolicy(**ONLINE_POLICY) if aware else None)
        engine._proxies[engine.strategy] = proxies
        # the spans measure wall time; the SLO arithmetic stays virtual
        engine.telemetry.tracer.clock = time.perf_counter
        streamed = []               # host seconds of each step's streaming
        stream_tokens = engine._stream_tokens

        def timed_stream(*a, **k):
            t = time.perf_counter()
            stream_tokens(*a, **k)
            streamed.append(time.perf_counter() - t)
        engine._stream_tokens = timed_stream
        with GcPauses() as pauses:
            events, index, wall = serve_arrivals(engine, clock, arrivals,
                                                 warm=False)
        torch.cuda.synchronize()
        m = online_metrics(engine, clock, index)
        n = check_streams(engine, events)
        assert n == m["completed"] == engine.stats.requests_done
        assert engine.pool.used == engine.prefix.held_pages, "pool leak"
        print(online_line("SLO-aware" if aware else "FIFO", m, wall)
              + f"; span medians ms: {phase_medians_ms(engine)}; "
              f"streaming {statistics.median(streamed) * 1e3:.3f} ms a "
              f"step (median); {pauses.line()}")
        outs[aware] = m["outputs"]
        if aware:
            assert m["boosted"] + m["preemptions"] + m["shed"] > 0, \
                "the SLO policy made no decision: nothing to compare"
            # the cache-dynamics probe's cost at this pool: each sample
            # copies every proxy arena to the host and diffs it
            sess = next(iter(engine._sessions.values()))
            nbytes = sum(b["proxy"].numel() * b["proxy"].element_size()
                         for b in sess.state.cache.arenas.values()
                         if "proxy" in b)
            times = []
            for _ in range(4):
                t = time.perf_counter()
                sess.cache_dynamics()
                times.append(time.perf_counter() - t)
            print(f"  cache_dynamics: {statistics.median(times[1:]) * 1e3:.1f}"
                  f" ms a sample ({nbytes / 1e6:.1f} MB of proxy arenas)")
        del engine
        torch.cuda.empty_cache()
    launches = _lib.launch_counts()
    common = sorted(set(outs[False]) & set(outs[True]))
    same = sum(outs[False][i] == outs[True][i] for i in common)
    print(f"  {same} of {len(common)} requests both passes complete decode "
          f"byte-identically (bf16)")
    print(f"  launches: {launches}")
    for name in SERVING_KERNELS:
        assert launches.get(name, 0) > 0, f"kernel {name} never launched"


class OverlapProbe:
    """Counts the steps whose device work was still running when the
    engine's ``_host_overlap`` ended: a CUDA event is recorded right after
    each ``sess.step()`` returns and queried at the end of the overlap.
    Also records a timing event just before the step, so that
    :meth:`lags` can say, once the card is idle, how far the device ran
    behind the host when the step returned (device ms from the first
    event to the second, less the host ms the step took to launch)."""

    def __init__(self, torch, engine):
        self.torch, self.engine = torch, engine
        self.pending = None
        self.busy = self.steps = 0
        self.records = []         # (start event, end event, host s, in flight)
        session_for, overlap = engine._session_for, engine._host_overlap

        def session_for_(lane):
            sess = session_for(lane)
            if not getattr(sess, "_probed", False):
                step = sess.step

                def step_():
                    start = torch.cuda.Event(enable_timing=True)
                    start.record()
                    t = time.perf_counter()
                    info = step()
                    host = time.perf_counter() - t
                    end = torch.cuda.Event(enable_timing=True)
                    end.record()
                    self.pending = (start, end, host)
                    return info
                sess.step, sess._probed = step_, True
            return sess

        def overlap_(lane, slots):
            overlap(lane, slots)
            if self.pending is not None:
                start, end, host = self.pending
                running = not end.query()
                self.steps += 1
                self.busy += int(running)
                self.records.append((start, end, host, running))
                self.pending = None

        engine._session_for, engine._host_overlap = session_for_, overlap_

    def lags(self) -> str:
        """Medians over the probed steps (call after a synchronize):
        device ms of a step from its first to its last launch, host ms of
        its launches, and their difference (> 0: the card still had that
        much of the step to run when ``sess.step()`` returned), for every
        step and for those still in flight at the end of the overlap."""
        rows = [(a.elapsed_time(b), host * 1e3, running)
                for a, b, host, running in self.records]
        if not rows:
            return "no step probed"

        def med(sel):
            got = [r for r in rows if sel(r)]
            if not got:
                return "none"
            return (f"device {statistics.median(r[0] for r in got):.2f} / "
                    f"host {statistics.median(r[1] for r in got):.2f} / "
                    f"lag {statistics.median(r[0] - r[1] for r in got):.2f}")
        return (f"all {len(rows)} steps {med(lambda r: True)}; in flight "
                f"{med(lambda r: r[2])}")


def online_http(torch, cfg, params, strat, proxies):
    """Phase 15(c): an ``AsyncFrontend`` on 127.0.0.1 over LLaDA-8B (the
    engine of (b) with the config's own SPA schedule and the SLO policy),
    real clock, tracer on.  Six clients stream over HTTP, submitted
    ``ONLINE_HTTP_STAGGER`` s apart (4 interactive prompt 96 + gen 96, 2
    batch prompt 128 + gen 256); one interactive client hangs up after its
    first token.  ``/debug/pool`` and ``/debug/requests`` are fetched
    mid-stream, ``/metrics`` at the end.  Asserts every other stream equals
    its ``done`` output, the dropped request ends canceled with its pages
    freed, ``/metrics`` parses as Prometheus text, the debug views as JSON,
    and the exported trace loads with every engine-phase span inside the
    serving window, in order on its lane.  Prints TTFT / TPOT in ms, ms an
    engine step and the engine-phase span medians online and offline
    (``run`` of the same six requests), the garbage collector's pauses in
    each, the event delivery latency, the share of steps still running on
    the card when ``_host_overlap`` ended and how far the device ran
    behind the host's launches (``OverlapProbe.lags``)."""
    import asyncio
    import tempfile

    import numpy as np
    from repro_torch.serving import frontend as fe
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.slo import SLO, SLOPolicy
    from repro_torch.serving.telemetry import PID_ENGINE, Telemetry

    c = ONLINE_FULL
    engine = ServingEngine(
        cfg, params, max_batch=c["slots"], canvas_len=c["canvas"],
        strategy=strat, pool_pages=c["pool"], page_size=PAGE,
        prefix_cache=True, slo_policy=SLOPolicy(**ONLINE_POLICY),
        telemetry=Telemetry.enabled(dynamics_every=0))
    engine._proxies[engine.strategy] = proxies
    probe = OverlapProbe(torch, engine)
    rng = np.random.default_rng(17)
    reqs = [(rng.integers(0, cfg.vocab_size - 1, p).astype(np.int32), g)
            for p, g in ONLINE_HTTP]
    slos = {96: {"ttft": 30.0, "deadline": 120.0},
            256: {"deadline": 600.0}}
    prom = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^{}]*\})? \S+$")

    async def client(front, i, views):
        await asyncio.sleep(i * ONLINE_HTTP_STAGGER)
        prompt, gen = reqs[i]
        events, arrived = [], []
        agen = fe.stream_request(front.host, front.port, prompt, gen,
                                 slo=slos[gen])
        try:
            async for ev in agen:
                arrived.append(time.time() - ev["ts"])
                events.append(ev)
                if ev["kind"] == "token" and i == ONLINE_HTTP_DROP:
                    break
                if ev["kind"] == "token" and i == 1 and not views:
                    views["pool"] = await fe.fetch_debug_pool(
                        front.host, front.port)
                    views["requests"] = await fe.fetch_debug_requests(
                        front.host, front.port)
        finally:
            await agen.aclose()
        return events, arrived

    async def serve_all(front, views):
        got = await asyncio.gather(*(client(front, i, views)
                                     for i in range(len(reqs))))
        while engine.stats.requests_canceled < 1:   # the hang-up lands
            await asyncio.sleep(0.05)
        return got

    async def main():
        front = fe.AsyncFrontend(engine, max_steps=4096)
        start = time.time()          # the engine's (and tracer's) clock
        await front.start(serve_http=True)
        t0 = time.perf_counter()
        views = {}
        try:
            got = await asyncio.wait_for(serve_all(front, views), 300)
            t1 = time.perf_counter()
            steps = engine.stats.steps
            metrics = await fe.fetch_metrics(front.host, front.port)
        finally:
            await front.stop(timeout=120)
        return got, views, metrics, t1 - t0, steps, (start, time.time())

    gc_objects = len(gc.get_objects())
    with tempfile.TemporaryDirectory() as tmp:
        with GcPauses() as online_gc:
            got, views, metrics, wall, steps, window = asyncio.run(main())
        path = Path(tmp) / "trace.json"
        engine.export_trace(str(path))
        doc = json.loads(path.read_text())
    st = engine.stats
    pct = st.percentiles()
    by_uid = {r.uid: r for r in engine.done}
    dropped = None
    for i, (events, _) in enumerate(got):
        uid = events[0]["uid"]
        r = by_uid[uid]
        if i == ONLINE_HTTP_DROP:
            dropped = r
            continue
        assert events[-1]["kind"] == "done", f"client {i}: {events[-1]}"
        stream = {p: t for ev in events if ev["kind"] == "token"
                  for p, t in zip(ev["positions"], ev["tokens"])}
        assert sorted(stream) == list(range(r.gen_len)), f"client {i}"
        assert [stream[p] for p in range(r.gen_len)] \
            == events[-1]["tokens"] == [int(t) for t in r.output]
    assert dropped is not None and dropped.canceled and dropped.output is None
    assert dropped.pages is None and not dropped.holds
    assert engine.pool.used == engine.prefix.held_pages, "pool leak"
    assert st.requests_done == len(reqs) - 1 and st.requests_canceled == 1
    for line in metrics.rstrip("\n").split("\n"):
        if not line.startswith("# "):
            assert prom.match(line), f"bad exposition line {line!r}"
            float(line.rsplit(" ", 1)[1])
    assert "spa_engine_steps_total" in metrics
    assert set(views["requests"]) == {"queued", "running", "done"}
    assert views["pool"]["pool"]["used"] > 0
    # the trace: every engine-phase span inside the serving window, in
    # order dispatch -> host_overlap -> host_sync on its lane
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and e["pid"] == PID_ENGINE]
    assert spans and len(spans) % 3 == 0
    lo, hi = window[0] * 1e6, window[1] * 1e6
    names = [e["name"] for e in sorted(spans, key=lambda e: e["ts"])]
    assert names == ["dispatch", "host_overlap", "host_sync"] * (
        len(spans) // 3), "engine-phase spans out of order"
    assert all(lo <= e["ts"] and e["ts"] + e["dur"] <= hi for e in spans), \
        "an engine-phase span outside the serving window"
    delivery = [d for _, arrived in got for d in arrived]
    online_ms = wall / max(steps, 1) * 1e3
    busy, probed = probe.busy, probe.steps
    torch.cuda.synchronize()
    online_lags = probe.lags()
    medians = phase_medians_ms(engine)
    taken = {ph: len(xs) for ph, xs in phase_samples(engine).items()}
    # the same six requests offline, the index dropped and counters reset
    engine.drop_prefix_cache()
    engine.done.clear()
    engine.stats = type(engine.stats)()
    probe.records, probe.busy, probe.steps = [], 0, 0
    for prompt, gen in reqs:
        engine.submit(prompt, gen, slo=SLO(**slos[gen]))
    torch.cuda.synchronize()
    with GcPauses() as offline_gc:
        engine.run(max_steps=4096)
    torch.cuda.synchronize()
    offline_ms = engine._wall / max(engine.stats.steps, 1) * 1e3
    print(f"  6 clients over HTTP ({len(doc['traceEvents'])} trace events): "
          f"TTFT p50/p95 {pct['ttft_p50'] * 1e3:.1f}/"
          f"{pct['ttft_p95'] * 1e3:.1f} ms, TPOT p50/p95 "
          f"{pct['tpot_p50'] * 1e3:.2f}/{pct['tpot_p95'] * 1e3:.2f} ms; "
          f"the dropped client's request canceled, its pages freed")
    print(f"  ms an engine step: online {online_ms:.2f} ({steps} steps), "
          f"offline run of the same requests {offline_ms:.2f} "
          f"({engine.stats.steps} steps); span medians ms online: "
          f"{medians}; offline: {phase_medians_ms(engine, taken)}")
    print(f"  host: online {online_gc.line()}, offline {offline_gc.line()}"
          f"; {gc_objects} objects tracked at the start")
    print(f"  event delivery (RequestEvent.ts to the client) p50/p95 "
          f"{statistics.median(delivery) * 1e3:.2f}/"
          f"{float(np.percentile(delivery, 95)) * 1e3:.2f} ms over "
          f"{len(delivery)} events; steps still running on the card when "
          f"_host_overlap ended: {busy} of {probed} "
          f"({busy / max(probed, 1):.1%}), offline {probe.busy} of "
          f"{probe.steps}")
    print(f"  a step's device ms (first to last launch) / host ms of its "
          f"launches / lag, medians: online {online_lags}; offline "
          f"{probe.lags()}")
    del engine
    torch.cuda.empty_cache()


def online_serving(torch, cfg, params, strat, proxies, card: str):
    c = ONLINE_SMALL
    print(f"online exactness (2-layer full-width f32 LLaDA through "
          f"ServingEngine, canvas {c['canvas']}, pages of {c['page']}, "
          f"{c['slots']} slots, refresh_interval=1, StepClock; the JAX "
          f"bench's Poisson and bursty traces, FIFO and SLO-aware, "
          f"CudaBackend and TorchBackend)")
    online_exactness(torch)
    c = ONLINE_FULL
    print(f"online serving, virtual time (LLaDA-8B bf16, {cfg.n_layers} "
          f"layers, through "
          f"ServingEngine, canvas {c['canvas']}, pool {c['pool']} pages of "
          f"{PAGE}, {c['slots']} slots, refresh_interval=1; the JAX bench's "
          f"Poisson trace x{c['scale']}; {card})")
    online_full_width(torch, cfg, params, strat, proxies)
    print(f"online serving over HTTP (LLaDA-8B bf16, {cfg.n_layers} "
          f"layers, AsyncFrontend on "
          f"127.0.0.1, the config's SPA schedule, real clock, tracer on; "
          f"{card})")
    online_http(torch, cfg, params, strat, proxies)


# Phase 16: fault injection and the engine supervisor.  16(a) runs the JAX
# serving bench's part 5 (``benchmarks/bench_serving.py``, the seeded fault
# storm) at its own shape on a 2-layer f32 LLaDA; 16(b) five of its
# requests x8 in tokens and two repeats on LLaDA-8B under a plan that fires
# every site.
FAULT_SMALL = dict(canvas=32, page=4, pool=41, host=16, slots=4, scale=1,
                   requests=(0, 1, 2, 3, 4, 5), repeats=(), stream=())
# 16(b): those requests x8 but the fourth, then the fifth and the second
# again at priority 0: without repeats nothing is ever evicted at this
# pool, so no host-tier fault could fire and nothing could be promoted.
# The fewest requests at which every site fires (the six and a repeat of
# each took 1324 s for the whole script, measured on one H100, over its
# 1100 s budget).  The fourth submitted (the fifth request) streams: the
# disconnect burst cancels it.
FAULT_FULL = dict(canvas=256, page=PAGE, pool=73, host=32, slots=4, scale=8,
                  requests=(0, 1, 2, 4, 5), repeats=(4, 1), stream=(3,))
# part 5's storm, and the JAX engine's counters under it at 16(a)'s shape
# (BENCH_serving.json["faults"]["storm"]; the JAX engine on the CPU gives
# the same, tests/test_torch_supervisor_bench.py)
FAULT_STORM = dict(seed=7, rates={"pool_alloc": 0.03, "lane_stall": 0.02,
                                  "step_nan": 0.02, "host_store": 0.3,
                                  "host_corrupt": 0.3})
FAULT_STORM_RECORD = dict(steps=21, done=5, faulted=1, faults_injected=1,
                          alloc_faults=0, nan_quarantines=1,
                          watchdog_fires=0, checksum_failures=0,
                          cold_prefill_fallbacks=0, max_degrade_level=0)
# 16(b)'s plan and supervisor, chosen by 16(b)'s functions on the CPU at 2
# reduced layers (the probe sequence follows commits and admissions, not
# widths): every site fires once within the first 7 steps, the ladder
# climbs to L3 and is back at L0 by step 26 of the pass's 198; and what the
# chaos pass must give.  Which index entries an eviction demotes first
# follows their pages' stability, so it depends on the weights: the store
# refusal comes at the third demotion, after the corrupted first one is
# promoted (refused at the second, it pruned the corrupted unit for some
# weights, measured on one H100).  Six weight seeds at 2 reduced layers
# give these constants, and so does the JAX engine
# (tests/test_torch_faults_rehearsal*.py).
FAULT_PLAN = dict(at={"pool_alloc": (0,), "host_corrupt": (0,),
                      "host_store": (2,), "disconnect": (2,),
                      "step_nan": (4,), "lane_stall": (6,)})
FAULT_SUPERVISOR = dict(watchdog_budget=4, pressure_window=8, escalate_at=2,
                        cooldown=4)
FAULT_EXPECT = dict(
    log=[("pool_alloc", 0), ("host_corrupt", 0), ("host_store", 2),
         ("disconnect", 2), ("step_nan", 4), ("lane_stall", 6)],
    aborted=[4], canceled=[3],
    degradation_events=[(1, 1), (2, 2), (3, 3), (18, 2), (22, 1), (26, 0)])


def fault_workload(n: int, scale: int = 1, canvas: int = 32):
    """The JAX bench's ``_workload(cfg, n)`` at its config's vocab of 256
    (seed 0: prompts of 4-9 tokens, gens 6 to ``canvas`` - prompt,
    priorities 0-2), with every prompt token repeated and every gen
    multiplied ``scale`` times: (prompt, gen, priority) triples."""
    import numpy as np
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        p_len = int(rng.integers(4, 10))
        gen = int(rng.integers(6, canvas - p_len + 1))
        prompt = rng.integers(0, 255, p_len).astype(np.int32)
        out.append((np.repeat(prompt, scale), gen * scale,
                    int(rng.integers(0, 3))))
    return out


def fault_traffic(c: dict):
    """``c``'s requests of the six-request workload, then its repeats at
    priority 0 (so they are admitted last)."""
    reqs = fault_workload(6, c["scale"])
    return ([reqs[i] for i in c["requests"]]
            + [reqs[i][:2] + (0,) for i in c["repeats"]])


def fault_engine(cfg, params, strat, proxies, c: dict, *, plan=None,
                 sup=None, telemetry=None, device=None):
    """A supervised ``ServingEngine`` of shape ``c`` (prefix index on, host
    tier in f32) under ``FaultPlan(**plan)`` and
    ``SupervisorConfig(**sup)``, scoring with ``proxies``."""
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.faults import FaultPlan
    from repro_torch.serving.supervisor import SupervisorConfig
    engine = ServingEngine(
        cfg, params, max_batch=c["slots"], canvas_len=c["canvas"],
        strategy=strat, pool_pages=c["pool"], page_size=c["page"],
        prefix_cache=True, host_pages=c["host"], host_dtype="f32",
        fault_plan=None if plan is None else FaultPlan(**plan),
        supervise=True,
        supervisor_cfg=None if sup is None else SupervisorConfig(**sup),
        telemetry=telemetry, device=device)
    engine._proxies[engine.strategy] = proxies
    return engine


def serve_faults(engine, reqs, stream=()):
    """Submit every request at once (those indexed in ``stream`` streaming
    to a sink) and run the engine to the end.  Returns (output bytes, as
    int32 tokens, by request index; wall seconds)."""
    import numpy as np
    uids = []
    for i, (prompt, gen, prio) in enumerate(reqs):
        on = i in stream
        uids.append(engine.submit(prompt, gen, priority=prio, stream=on,
                                  sink=(lambda ev: None) if on else None))
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    by_uid = {r.uid: r for r in engine.done}
    return ({i: np.asarray(by_uid[u].output, np.int32).tobytes()
             for i, u in enumerate(uids) if by_uid[u].output is not None},
            wall)


class PoisonReuse:
    """While entered: the pages each ``step_nan`` fault poisons, and how
    many later page allocations hand those pages to a new owner (the NaN
    must not follow them: the pass's survivors match their clean twins)."""

    def __enter__(self):
        from repro_torch.dlm.session import DecodeSession
        from repro_torch.serving.pool import PagePool
        self.poisoned, self.reused = set(), 0
        self._saved = (DecodeSession.poison_cache_pages, PagePool.alloc)
        poison, alloc = self._saved

        def record_poison(sess, pages):
            self.poisoned.update(pages)
            return poison(sess, pages)

        def record_alloc(pool, n):
            pages = alloc(pool, n)
            self.reused += len(set(pages or ()) & self.poisoned)
            return pages
        DecodeSession.poison_cache_pages = record_poison
        PagePool.alloc = record_alloc
        return self

    def __exit__(self, *exc):
        from repro_torch.dlm.session import DecodeSession
        from repro_torch.serving.pool import PagePool
        DecodeSession.poison_cache_pages, PagePool.alloc = self._saved

    def line(self) -> str:
        return (f"{len(self.poisoned)} poisoned pages, handed out again "
                f"{self.reused} times")


def fault_counters(engine) -> dict:
    """The JAX bench's ``_serve_chaos`` counters."""
    s = engine.stats
    return dict(steps=s.steps, done=s.requests_done,
                faulted=s.requests_faulted,
                faults_injected=s.faults_injected,
                alloc_faults=s.alloc_faults,
                nan_quarantines=s.nan_quarantines,
                watchdog_fires=s.watchdog_fires,
                checksum_failures=s.host_checksum_failures,
                cold_prefill_fallbacks=s.cold_prefill_fallbacks,
                max_degrade_level=max(
                    [lvl for _, lvl in s.degradation_events], default=0))


def fault_outcome(engine) -> dict:
    """What a chaos pass must replay: the injector's log, the aborted and
    canceled uids and the ladder's moves."""
    return dict(
        log=list(engine.faults.log) if engine.faults else [],
        aborted=sorted(r.uid for r in engine.done if r.fault is not None),
        canceled=sorted(r.uid for r in engine.done
                        if r.canceled and r.fault is None),
        degradation_events=list(engine.stats.degradation_events))


def drain_tiers(engine) -> None:
    """Aborted work left nothing behind: the pool holds the index's pages
    only, the host tier the trie's refs; both empty after
    ``drop_prefix_cache``."""
    assert engine.pool.used == engine.prefix.held_pages, "pool leak"
    assert engine.host_pool.used_pages == engine.prefix.host_held_pages, \
        "host tier leak"
    engine.drop_prefix_cache()
    assert engine.pool.used == 0 and engine.host_pool.used_pages == 0


def storm_passes(cfg, params, strat, proxies, *, device=None):
    """16(a)'s two passes through one backend (``strat``'s): clean, then
    under ``FAULT_STORM``.  Returns (clean outputs, storm outputs, storm
    counters, storm outcome, (clean wall, storm wall))."""
    c = FAULT_SMALL
    reqs = fault_traffic(c)
    clean = fault_engine(cfg, params, strat, proxies, c, device=device)
    clean_out, clean_wall = serve_faults(clean, reqs)
    drain_tiers(clean)
    storm = fault_engine(cfg, params, strat, proxies, c, plan=FAULT_STORM,
                         device=device)
    storm_out, storm_wall = serve_faults(storm, reqs)
    counters, outcome = fault_counters(storm), fault_outcome(storm)
    assert counters["done"] + counters["faulted"] == len(reqs), \
        "the storm lost requests"
    drain_tiers(storm)
    return clean_out, storm_out, counters, outcome, (clean_wall, storm_wall)


def chaos_passes(cfg, params, strat, proxies, *, device=None,
                 telemetry=None):
    """16(b)'s two passes: clean under ``supervise=True``, then under
    ``FAULT_PLAN`` and ``FAULT_SUPERVISOR``.  Returns (clean outputs,
    chaos outputs, chaos engine (its tiers drained), (clean wall, chaos
    wall, clean steps))."""
    c = FAULT_FULL
    reqs = fault_traffic(c)
    clean = fault_engine(cfg, params, strat, proxies, c, device=device)
    clean_out, clean_wall = serve_faults(clean, reqs, c["stream"])
    drain_tiers(clean)
    steps = clean.stats.steps
    del clean
    chaos = fault_engine(cfg, params, strat, proxies, c, plan=FAULT_PLAN,
                         sup=FAULT_SUPERVISOR, telemetry=telemetry,
                         device=device)
    chaos_out, chaos_wall = serve_faults(chaos, reqs, c["stream"])
    drain_tiers(chaos)
    return clean_out, chaos_out, chaos, (clean_wall, chaos_wall, steps)


def faults_small(torch):
    """Phase 16(a): the JAX bench's part 5 at its own shape (canvas 32,
    pages of 4, 41 pages, 4 slots, host tier of 16 pages in f32, prefix
    index on, ``SPACache(rank=16, uniform, rho_peak=0.3,
    refresh_interval=1)``) on a 2-layer, full-width f32 LLaDA, through
    ``CudaBackend`` and ``TorchBackend``: a clean pass, then the seeded
    storm.  Asserts the same injector log, aborted uids, counters and
    outputs on both backends, survivors byte-identical to the clean pass,
    both tiers drained, and the counters equal to the JAX engine's
    (``FAULT_STORM_RECORD``)."""
    from repro_torch.core.strategy import SPACache
    from repro_torch.kernels import _lib

    cfg, params, _, _, _ = _parity_setup(torch, "float32")
    strat = SPACache(rank=16, schedule="uniform", rho_peak=0.3,
                     refresh_interval=1)
    proxies = strat.build_proxies(params, cfg)
    runs = {}
    _lib.reset_launch_counts()
    for backend in ("cuda", "torch"):
        with oracle_launches_nothing(f"16(a) {backend}",
                                     active=backend == "torch"), \
                PoisonReuse() as reuse:
            runs[backend] = storm_passes(cfg, params,
                                         strat.with_backend(backend),
                                         proxies)
        torch.cuda.synchronize()
        print(f"  {backend}: {reuse.line()}")
        assert reuse.reused, "16(a): no poisoned page was handed out again"
    launches = _lib.launch_counts()
    clean, storm, counters, outcome, walls = runs["cuda"]
    assert runs["torch"][1:4] == (storm, counters, outcome), \
        "16(a): the backends diverged"
    assert runs["torch"][0] == clean
    survivors = sorted(storm)
    assert all(storm[i] == clean[i] for i in survivors), \
        "16(a): a survivor differs from its fault-free twin"
    print(f"  storm {FAULT_STORM['rates']} (seed {FAULT_STORM['seed']}): "
          f"log {outcome['log']}, aborted uids {outcome['aborted']}; the "
          f"same on TorchBackend; {len(survivors)} survivors "
          f"byte-identical to the clean pass")
    print("  counters (JAX engine's in brackets): " + ", ".join(
        f"{k} {counters[k]} ({v})" for k, v in FAULT_STORM_RECORD.items()))
    print(f"  wall: clean {walls[0]:.2f} s, storm {walls[1]:.2f} s "
          f"(CudaBackend); launches {launches}")
    assert counters == FAULT_STORM_RECORD, "16(a): counters differ from JAX"
    for name in SERVING_KERNELS:
        assert launches.get(name, 0) > 0, f"kernel {name} never launched"
    del params, proxies
    torch.cuda.empty_cache()


def faults_full(torch, cfg, params, strat, proxies):
    """Phase 16(b): LLaDA-8B through ``ServingEngine`` (canvas 256, pages of
    16, 4 slots, 73 pages, host tier of 32 pages in f32, prefix index on,
    the config's SPA with ``refresh_interval=1``) on five of 16(a)'s
    requests x8 in tokens and two repeats: a clean pass under
    ``supervise=True``,
    then a chaos pass under ``FAULT_PLAN`` (every site fires) and
    ``FAULT_SUPERVISOR``, the tracer on.  Asserts the rehearsal's
    injector log, aborted and canceled uids and ladder moves
    (``FAULT_EXPECT``; up to L3 and back to L0), a NaN quarantine, a cold
    prefill after the corrupted page, a watchdog recovery, an invariant
    check every iteration and both tiers drained.  Prints how many
    survivors equal their clean twins byte for byte (bf16: only lockstep
    parity holds), wall ms a step of both passes and the ``supervisor``
    span's median against the step's."""
    from repro_torch.kernels import _lib
    from repro_torch.serving.telemetry import Telemetry, Tracer

    strat = dataclasses.replace(strat, refresh_interval=1)
    tel = Telemetry(tracer=Tracer(enabled=True))
    _lib.reset_launch_counts()
    with PoisonReuse() as reuse:
        clean, chaos_out, chaos, (cw, xw, csteps) = chaos_passes(
            cfg, params, strat, proxies, telemetry=tel)
    torch.cuda.synchronize()
    print(f"  {reuse.line()}")
    launches = _lib.launch_counts()
    s = chaos.stats
    outcome = fault_outcome(chaos)
    print(f"  chaos: log {outcome['log']}; aborted {outcome['aborted']}, "
          f"canceled {outcome['canceled']}; ladder "
          f"{outcome['degradation_events']}")
    print(f"  counters: {fault_counters(chaos)}, preemptions "
          f"{s.preemptions}, disconnect bursts {s.disconnect_bursts}, "
          f"refused stores {s.tier_store_faults}, pages demoted "
          f"{s.prefix_demoted_pages} / dropped {s.prefix_dropped_pages} / "
          f"promoted {s.prefix_promoted_pages}, publications paused "
          f"{s.publish_paused_skips}, invariant checks "
          f"{s.invariant_checks}")
    same = sum(chaos_out[i] == clean[i] for i in chaos_out)
    samples = phase_samples(chaos)
    sup = chaos.telemetry.registry.histogram(
        "spa_engine_phase_seconds", labels={"phase": "supervisor"}).samples
    step_ms = [sum(x) * 1e3 for x in zip(*samples.values())]
    print(f"  {same} of {len(chaos_out)} survivors equal their clean twins "
          f"byte for byte (bf16); wall ms a step: clean "
          f"{cw / max(csteps, 1) * 1e3:.2f} ({csteps} steps), chaos "
          f"{xw / max(s.steps, 1) * 1e3:.2f} ({s.steps} steps); span "
          f"medians ms: supervisor {statistics.median(sup) * 1e3:.3f}, "
          f"dispatch + host_overlap + host_sync "
          f"{statistics.median(step_ms):.2f}")
    print(f"  launches: {launches}")
    for key, want in FAULT_EXPECT.items():
        assert outcome[key] == want, f"16(b): {key} {outcome[key]} != {want}"
    levels = [lvl for _, lvl in outcome["degradation_events"]]
    assert 3 in levels and levels[-1] == 0, "16(b): the ladder's walk"
    assert {site for site, _ in outcome["log"]} == set(
        FAULT_PLAN["at"]), "16(b): a fault site never fired"
    assert s.nan_quarantines >= 1, "16(b): no NaN quarantine"
    assert s.cold_prefill_fallbacks >= 1, "16(b): no cold fallback"
    assert s.watchdog_fires >= 1, "16(b): no watchdog recovery"
    assert s.invariant_checks >= s.steps - s.watchdog_fires, \
        "16(b): an iteration went unchecked"
    for name in SERVING_KERNELS:
        assert launches.get(name, 0) > 0, f"kernel {name} never launched"
    del chaos
    torch.cuda.empty_cache()


def faults_phase(torch, cfg, params, strat, proxies, card: str):
    c = FAULT_SMALL
    print(f"fault storm (2-layer full-width f32 LLaDA through "
          f"ServingEngine, canvas {c['canvas']}, pages of {c['page']}, pool "
          f"{c['pool']}, host tier {c['host']} pages f32, {c['slots']} "
          f"slots; the JAX bench's part 5, CudaBackend and TorchBackend)")
    faults_small(torch)
    c = FAULT_FULL
    print(f"faults at full width (LLaDA-8B bf16 through ServingEngine, "
          f"canvas {c['canvas']}, pool {c['pool']} pages of {c['page']}, "
          f"host tier {c['host']} pages f32, {c['slots']} slots, "
          f"refresh_interval=1; {len(c['requests'])} of the storm's "
          f"requests x{c['scale']} and {len(c['repeats'])} repeats; {card})")
    faults_full(torch, cfg, params, strat, proxies)


# ---------------------------------------------------------------------------
# Phase 17: profiling through the server; recurrent stacks in lanes
# ---------------------------------------------------------------------------

PROFILE17 = dict(canvas=256, slots=4, pool=4 * (256 // PAGE) + 1,
                 requests=((128, 64), (64, 64), (192, 64), (96, 32)))
PROBES17 = dict(batch=4, seq=512, n_selected=128, page=PAGE)
PROBE_KERNELS = {"identify": "cosine_drift", "gather": "gather_norm",
                 "attend": "sparse_attention",
                 "scatter": "scatter_update_multi",
                 "page_gather": "gather_pages"}
# the hand-written kernels a ``serve --profile --torch-trace-dir`` trace
# must name (KERNEL_GROUPS' keys): attention, gather_norm, the row commit
# and the page copies
TRACE_GROUPS = ("sparse_attention (dense + banded)", "gather_norm",
                "scatter_update_multi", "gather_pages + scatter_pages")
# 17(b): six requests (prompt, gen, priority) at canvas 32, pages of 4: the
# first served alone (it publishes), then its repeat, three more, and a
# priority-5 one arriving at the second step on a short pool (preempts)
RECURRENT_SMALL = dict(canvas=32, page=4, slots=4, pool=25,
                       first=(8, 8), wave=((8, 8), (6, 12), (8, 16), (8, 8)),
                       late=(8, 16))
HYBRID_CUT = 12            # RecurrentGemma-9B's first 12 of 38 layers
# 17(c): 6 requests a server, the last two repeating the first two's
# prompts and layouts (full hits); the pool holds 4 rows and the index's
# copies of 4
RECURRENT_FULL = {
    "hybrid": dict(canvas=4096, slots=4, gen=32,
                   prompts=(4064, 4000, 4032, 3968)),
    "mamba2": dict(canvas=1024, slots=4, gen=32,
                   prompts=(992, 960, 928, 896)),
}
RECURRENT_PROFILE = (6, 9)    # engine steps after which the trace starts/ends


def _serve(engine, reqs):
    """Submit (prompt, gen) pairs and run; returns (outputs by uid, wall)."""
    import numpy as np
    for prompt, gen in reqs:
        engine.submit(prompt, gen)
    t0 = time.perf_counter()
    engine.run()
    wall = time.perf_counter() - t0
    return ({r.uid: np.asarray(r.output).tobytes() for r in engine.done},
            wall)


def tracker_host_us(sess, calls: int = 2000) -> float:
    """Host µs the trace accounting adds to one step: a wrapped no-op at
    the session's step signature against the bare no-op."""
    from repro_torch.core import runtime
    noop = (lambda state: None)
    wrapped = runtime.CompileTracker().wrap(
        noop, name="probe", signature=sess._state_signature)
    times = []
    for fn in (wrapped, noop):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(sess.state)
        times.append(time.perf_counter() - t0)
    return max(0.0, times[0] - times[1]) / calls * 1e6


def trace_kernel_groups(path) -> dict:
    """KERNEL_GROUPS -> kernel events of a Chrome trace of that group."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    found = {}
    for ev in events:
        if ev.get("cat") != "kernel":
            continue
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(_matches(ev.get("name", ""), k) for k in keys)),
                     None)
        if group is not None:
            found[group] = found.get(group, 0) + 1
    return found


def profiling_serving(torch, cfg, params, strat, proxies, *, device=None):
    """Phase 17(a): LLaDA-8B's cut through ``ServingEngine`` on CudaBackend
    (canvas 256, pages of 16, 65 pages, 4 slots, four requests), without a
    ``StepProfiler`` and with one: identical outputs and step counts, the
    fenced segments tile the total; the refresh / dispatch / device_wait
    shares, the trace accounting's host µs a step, the ``spa_runtime_*``
    series and ``live_executables``; then ``KernelPhaseProbes`` at
    LLaDA-8B's widths (bf16), and ``serve --profile --torch-trace-dir`` on
    the reduced llada-8b, whose trace must name the hand-written
    kernels."""
    import io

    import numpy as np
    from repro_torch.core import runtime
    from repro_torch.kernels import _lib
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.profiling import KernelPhaseProbes, StepProfiler
    from repro_torch.serving.telemetry import MetricsRegistry, Telemetry

    c = PROFILE17
    rng = np.random.default_rng(17)
    reqs = [(rng.integers(0, cfg.vocab_size - 1, p), g)
            for p, g in c["requests"]]
    runs = {}
    for label, prof in (("warm", None), ("off", None),
                        ("on", StepProfiler(Telemetry.enabled(
                            dynamics_every=0)))):
        engine = ServingEngine(cfg, params, max_batch=c["slots"],
                               canvas_len=c["canvas"], strategy=strat,
                               pool_pages=c["pool"], page_size=PAGE,
                               telemetry=(prof.telemetry if prof else None),
                               profiler=prof, device=device)
        engine._proxies[engine.strategy] = proxies
        out, wall = _serve(engine, reqs)
        runs[label] = (out, engine.stats.steps, wall, engine, prof)
    out_on, steps_on, wall_on, engine, prof = runs["on"]
    out_off, steps_off, wall_off = runs["off"][:3]
    assert out_on == out_off and steps_on == steps_off, \
        "17(a): profiling changed the served outputs or steps"
    for r in engine.done:
        assert not (np.asarray(r.output) == cfg.mask_id).any()
    assert prof.steps_observed == steps_on
    snap = prof.registry.snapshot()
    seg_sum = sum(snap[f'spa_profile_step_seconds{{segment="{s}"}}']["sum"]
                  for s in StepProfiler.SEGMENTS)
    total = snap['spa_profile_step_seconds{segment="total"}']["sum"]
    assert abs(seg_sum - total) <= 1e-6 * total, \
        f"17(a): segments sum to {seg_sum}, total {total}"
    bd = prof.step_breakdown()
    sess = next(iter(engine._sessions.values()))
    print(f"  {len(reqs)} requests, {steps_on} engine steps either way, "
          f"outputs identical; wall {wall_off:.3f} s unprofiled, "
          f"{wall_on:.3f} s profiled ({wall_off / steps_off * 1e3:.2f} / "
          f"{wall_on / steps_on * 1e3:.2f} ms an engine step)")
    print("  fenced step: " + ", ".join(
        f"{s} {bd[s]['mean_s'] * 1e3:.3f} ms ({bd[s]['share']:.1%})"
        for s in StepProfiler.SEGMENTS)
        + f"; segments sum to the total within {abs(seg_sum - total):.1e} s")
    print(f"  trace accounting: {tracker_host_us(sess):.2f} host us a step; "
          f"traces {runtime.compile_tracker().snapshot()['traces']}")
    text = engine.render_metrics()
    live = engine.pool_debug_state()["live_executables"]
    for series in ("spa_runtime_trace_total", "spa_runtime_live_executables",
                   "spa_profile_step_seconds"):
        assert series in text, f"17(a): {series} missing from the render"
    on_card = (device or "cuda") != "cpu"
    assert live >= on_card, f"17(a): live_executables {live}"
    print(f"  /metrics carries spa_runtime_*; live_executables {live}")
    del runs, engine, sess
    torch.cuda.empty_cache()

    reg = MetricsRegistry()
    probes = KernelPhaseProbes(cfg, strategy=strat, backend="cuda",
                               registry=reg, dtype=torch.bfloat16,
                               device=device, **PROBES17)
    for phase, rec in probes.run(reps=5).items():
        print(f"  probe {phase:>11}: first call {rec['compile_s'] * 1e3:8.3f}"
              f" ms, steady {rec['steady_s'] * 1e3:8.3f} ms, launches "
              f"{rec['launches']}")
        if on_card:
            assert rec["launches"].get(PROBE_KERNELS[phase], 0) >= 1, \
                f"17(a): probe {phase} launched {rec['launches']}"

    trace_dir = _lib.BUILD_DIR / "trace17"
    argv = ["--arch", "llada-8b", "--requests", "4", "--gen-len", "16",
            "--canvas", "64", "--max-batch", "2", "--pool-pages", "17",
            "--page-size", str(PAGE), "--profile", "--torch-trace-dir",
            str(trace_dir)]
    if device is not None:
        argv += ["--device", str(device)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert serve_cli.main(argv) == 0
    lines = buf.getvalue().splitlines()
    for line in lines:
        if line.startswith(("served ", "    refresh", "    dispatch",
                            "    device_wait", "    total",
                            "most-retraced", "     ", "torch trace")):
            print(f"  serve: {line.strip()}")
    found = trace_kernel_groups(trace_dir / "trace.json")
    print(f"  serve trace kernels by group: {found}")
    if on_card:
        missing = [g for g in TRACE_GROUPS if not found.get(g)]
        assert not missing, f"17(a): the trace names no {missing} kernel"


def _recurrent_traffic(cfg, c: dict, seed: int = 0):
    """RECURRENT_SMALL's prompts: (first, wave, late) as (prompt, gen)."""
    import numpy as np
    rng = np.random.default_rng(seed)

    def req(p, g):
        return rng.integers(0, cfg.vocab_size - 1, p).astype(np.int32), g
    first = req(*c["first"])
    wave = [first] + [req(p, g) for p, g in c["wave"][1:]]
    return first, wave, req(*c["late"])


def recurrent_churn(engine, cfg, c: dict) -> dict:
    """17(b)'s traffic through ``engine``: the first request alone, then
    its repeat and three more, a priority-5 arrival at the wave's second
    step.  Returns the run's record (outputs by uid, counters)."""
    import numpy as np
    first, wave, late = _recurrent_traffic(cfg, c)
    engine.submit(*first)
    engine.run()
    for prompt, gen in wave:
        engine.submit(prompt, gen)
    s0, pending = engine.stats.steps, [late]

    def on_step(e):
        if pending and e.stats.steps >= s0 + 2:
            e.submit(*pending.pop(), priority=5)

    engine.run(on_step=on_step)
    s = engine.stats
    return dict(outputs={r.uid: np.asarray(r.output).tobytes()
                         for r in engine.done},
                counters=dict(steps=s.steps, swaps=s.swaps,
                              preemptions=s.preemptions,
                              done=s.requests_done, hits=s.prefix_hits,
                              full_hits=s.prefix_full_hits,
                              published=s.prefix_published))


def recurrent_small_cfgs(torch):
    """17(b)'s models: full-width RecurrentGemma (rglru, rglru, local) and
    Mamba2 of 3 layers each, in f32."""
    from repro_torch.configs import get_arch
    return {name: dataclasses.replace(get_arch(arch), n_layers=3,
                                      param_dtype="float32")
            for name, arch in (("hybrid", "recurrentgemma-9b"),
                               ("mamba2", "mamba2-370m"))}


def recurrent_exactness(torch, cfgs=None, *, device=None) -> dict:
    """Phase 17(b): each of ``cfgs`` (default ``recurrent_small_cfgs``)
    through ``ServingEngine`` (canvas 32, 4 slots; dense lanes, then paged
    lanes of pages of 4 with the prefix index on) on CudaBackend and
    TorchBackend: the same outputs, steps, swaps, preemptions and prefix
    hits on both; every request served, the paged lanes preempt, the
    hybrid's repeat is a full hit.  Returns {(name, mode): record}."""
    from repro_torch.core.strategy import resolve_strategy
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer
    from repro_torch.serving.engine import ServingEngine

    c = RECURRENT_SMALL
    cfgs = cfgs or recurrent_small_cfgs(torch)
    records = {}
    for name, cfg in cfgs.items():
        params = transformer.init_params(cfg, seed=7, device=device)
        strat = resolve_strategy(cfg)
        proxies = strat.build_proxies(params, cfg)
        for mode in ("dense", "paged"):
            paged = mode == "paged"
            runs = {}
            _lib.reset_launch_counts()
            for backend in ("cuda", "torch"):
                with oracle_launches_nothing(f"17(b) {name} {mode}",
                                             active=backend == "torch"):
                    engine = ServingEngine(
                        cfg, params, max_batch=c["slots"],
                        canvas_len=c["canvas"],
                        strategy=strat.with_backend(backend),
                        pool_pages=c["pool"] if paged else 0,
                        page_size=c["page"], prefix_cache=paged,
                        device=device)
                    engine._proxies[engine.strategy] = proxies
                    runs[backend] = recurrent_churn(engine, cfg, c)
                if backend == "cuda":
                    launches = _lib.launch_counts()
            rec = runs["cuda"]
            assert runs["torch"] == rec, \
                f"17(b) {name} {mode}: the backends diverged"
            n = rec["counters"]
            assert n["done"] == 2 + len(c["wave"]), f"17(b): {n}"
            assert (n["preemptions"] > 0) == paged, f"17(b) {name}: {n}"
            if paged and name == "hybrid":
                assert n["full_hits"] >= 1, f"17(b) hybrid: {n}"
            if paged and name == "mamba2":
                assert n["hits"] == n["published"] == 0, f"17(b): {n}"
            scan = "rglru_scan" if name == "hybrid" else "ssd_chunk_scan"
            if (device or "cuda") != "cpu":
                assert launches[scan] > 0, f"17(b): {scan} never launched"
            print(f"  {name} {mode}: {n}; the same on TorchBackend; "
                  f"{scan} launches {launches[scan]}")
            records[(name, mode)] = rec
        del params, proxies
        torch.cuda.empty_cache()
    return records


class StepLaunches:
    """While entered: each lane step's kernel launches (the deltas of
    ``_lib.LAUNCHES`` around ``DecodeSession._serve_step``, which runs the
    step's layers and nothing of admission or refresh)."""

    def __init__(self, kernels):
        self.kernels = kernels
        self.steps = []

    def __enter__(self):
        from repro_torch.dlm.session import DecodeSession
        from repro_torch.kernels import _lib
        self._real = real = DecodeSession._serve_step
        probe = self

        def counted(sess, state):
            before = _lib.launch_counts()
            out = real(sess, state)
            after = _lib.launch_counts()
            probe.steps.append({k: after[k] - before[k]
                                for k in probe.kernels})
            return out

        DecodeSession._serve_step = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.dlm.session import DecodeSession
        DecodeSession._serve_step = self._real
        return False


def recurrent_server(torch, name, cfg, params, strat, proxies, c, expect,
                     *, device=None):
    """One 17(c) server: paged, pages of 16, prefix index on, ``c``'s four
    prompts then repeats of the first two (full hits where the stack has
    attention arenas), with a ``torch.profiler`` window.  Every request
    completes with no [MASK] left and every lane step launches ``expect``
    (kernel -> launches a step)."""
    import numpy as np
    from repro_torch.kernels import _lib
    from repro_torch.serving.engine import ServingEngine

    n_pages = c["canvas"] // PAGE
    engine = ServingEngine(cfg, params, max_batch=c["slots"],
                           canvas_len=c["canvas"], strategy=strat,
                           pool_pages=2 * c["slots"] * n_pages + 1,
                           page_size=PAGE, prefix_cache=True, device=device)
    if proxies is not None:
        engine._proxies[engine.strategy] = proxies
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, cfg.vocab_size - 1, p) for p in c["prompts"]]
    on_card = (device or "cuda") != "cpu"
    prof = new_profiler(torch) if on_card else None
    seen = {}

    def on_step(e):
        if prof is not None and e.stats.steps in RECURRENT_PROFILE:
            torch.cuda.synchronize()
            if e.stats.steps == RECURRENT_PROFILE[0]:
                prof.start()
                seen["t0"] = time.perf_counter()
            else:
                prof.stop()
                seen["wall_us"] = (time.perf_counter() - seen["t0"]) * 1e6

    for p in prompts + prompts[:2]:
        engine.submit(p, c["gen"])
    _lib.reset_launch_counts()
    with StepLaunches(tuple(expect)) as probe:
        t0 = time.perf_counter()
        stats = engine.run(on_step=on_step)
        wall = time.perf_counter() - t0
    assert stats.requests_done == len(prompts) + 2, \
        f"17(c) {name}: {stats.requests_done} requests done"
    for r in engine.done:
        assert len(r.output) == c["gen"]
        assert not (np.asarray(r.output) == cfg.mask_id).any(), \
            f"17(c) {name}: uid {r.uid} left a mask"
    if on_card:
        bad = [d for d in probe.steps if d != expect]
        assert not bad, f"17(c) {name}: step launches {bad[:2]}, want {expect}"
    window = RECURRENT_PROFILE[1] - RECURRENT_PROFILE[0]
    ms = ((wall - seen["wall_us"] / 1e6) / (stats.steps - window) * 1e3
          if prof is not None else wall / stats.steps * 1e3)
    print(f"  {name}: {stats.requests_done} requests, {stats.steps} engine "
          f"steps, {ms:.2f} ms an engine step outside the profiled window "
          f"(wall {wall:.2f} s), swaps {stats.swaps}, prefix hits "
          f"{stats.prefix_hits} ({stats.prefix_full_hits} full), published "
          f"{stats.prefix_published} pages; launches a step {expect} "
          f"({len(probe.steps)} steps)")
    if prof is not None:
        _, dev_ms = report_profile(prof, window, seen["wall_us"],
                                   f"{name} engine")
        if dev_ms:
            print(f"  {name}: {dev_ms:.2f} device ms a step against "
                  f"{ms:.2f} unprofiled wall ms: busy {dev_ms / ms:.1%}")
    del engine
    torch.cuda.empty_cache()
    return stats


def recurrent_full_width(torch, hybrid=None, *, device=None):
    """Phase 17(c): RecurrentGemma-9B cut to its first 12 layers (8 RG-LRU,
    4 local; phase 9's weights when it ran, else the cut's own) and
    Mamba2-370m at full depth through ``ServingEngine`` in bf16
    (``RECURRENT_FULL``).  The launches a lane step are phases 9's and
    11's: rglru_scan twice an RG-LRU layer, one attention call a local
    layer (the banded grid where its q span engages it), ssd_chunk_scan
    twice an SSD layer."""
    from repro_torch.configs import get_arch
    from repro_torch.core import spa_layer
    from repro_torch.core.strategy import SPACache, resolve_strategy
    from repro_torch.kernels.sparse_attention import banded_engages
    from repro_torch.models import transformer

    full = get_arch("recurrentgemma-9b")
    if hybrid is None:
        cut_cfg = llada_cut(full, {"blocks": {}}, {}, HYBRID_CUT)[0]
        params = transformer.init_params(cut_cfg, seed=0, device=device)
        strat = SPACache.from_spec(cut_cfg.spa)
        hybrid = (cut_cfg, params, strat, strat.build_proxies(params,
                                                              cut_cfg))
        print(f"  RecurrentGemma-9B's first {HYBRID_CUT} layers: own weights")
    else:
        hybrid = llada_cut(full, hybrid[0], hybrid[1], HYBRID_CUT)
        print(f"  RecurrentGemma-9B's first {HYBRID_CUT} layers: phase 9's "
              f"weights")
    cfg, params, strat, proxies = hybrid
    c = RECURRENT_FULL["hybrid"]
    n = c["canvas"]
    ks = spa_layer.layer_ks(cfg, strat, n)
    attn = [l for l in range(cfg.n_layers) if cfg.kind_of_layer(l) == "local"]
    banded = sum(banded_engages(n, cfg.window, True, spa_layer.q_span_bound(
        n, ks[l], spa_layer.stratify_blocks_for(n, ks[l]))) for l in attn)
    expect = {"rglru_scan": 2 * (cfg.n_layers - len(attn)),
              "sparse_attention": len(attn) - banded,
              "sparse_attention_banded": banded}
    print(f"  hybrid cut {cfg.layer_kinds.count('rglru')} RG-LRU + "
          f"{len(attn)} local layers; k {[ks[l] for l in attn]}")
    h = recurrent_server(torch, "RecurrentGemma-9B cut", cfg, params, strat,
                         proxies, c, expect, device=device)
    assert h.prefix_full_hits >= 1, "17(c): the hybrid's repeats never hit"
    del hybrid, params, proxies
    torch.cuda.empty_cache()

    cfg = get_arch("mamba2-370m")
    params = transformer.init_params(cfg, seed=0, device=device)
    m = recurrent_server(torch, "Mamba2-370m", cfg, params,
                         resolve_strategy(cfg), None,
                         RECURRENT_FULL["mamba2"],
                         {"ssd_chunk_scan": 2 * cfg.n_layers}, device=device)
    assert m.prefix_hits == 0
    del params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 18: MoE and VLM decode and serving at full width, cut by depth
# ---------------------------------------------------------------------------

MOE_CUT = 8               # the MoE and VLM configs' first 8 layers
MOE = (("mixtral-8x22b", 4, 256), ("qwen3-moe-235b-a22b", 4, 256))
MOE_GEN = 256
MOE_SPA_STEPS = 16
MOE_NOCACHE_STEPS = 4
MOE_SERVE = dict(canvas=256, slots=4, gen=32, prompts=(160, 96, 200))
VLM = dict(name="internvl2-76b", b=4, patches=1024, prompt=256)
# the MoE stages a profiled window attributes by name (models/moe.py)
MOE_RANGES = {"_dispatch": "routing / gather / combine",
              "_gather": "routing / gather / combine",
              "_combine": "routing / gather / combine",
              "_experts": "expert products"}
SPA_KERNEL_KEYS = ("proxy_wgmma", "proxy_tf32", "PagedRows",
                   "cosine_drift_kernel", "gather_norm", "scatter_kernel",
                   "page_copy_kernel", "rows_paged_kernel")
ATTENTION_KEYS = ("attention_bf16_wgmma", "attention_i8_wgmma",
                  "attention_tf32_wgmma")


class MoeRanges:
    """While entered, each MoE stage function runs inside a
    ``torch.profiler.record_function`` range named ``moe<stage>``, so a
    trace can attribute the kernels each stage launches."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self._saved = {name: getattr(moe, name) for name in MOE_RANGES}
        for name, fn in self._saved.items():
            def ranged(*a, _fn=fn, _name=f"moe{name}", **kw):
                with torch.profiler.record_function(_name):
                    return _fn(*a, **kw)
            setattr(moe, name, ranged)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        for name, fn in self._saved.items():
            setattr(moe, name, fn)
        return False


def moe_profile(torch, step, n_steps: int, label: str):
    """A ``torch.profiler`` window of ``n_steps`` steps under
    :class:`MoeRanges`: device ms a step of the expert products, the
    routing / gather / combine, the attention kernel, the SPA kernels
    (identification, gather + norm, commits, page movers) and all other
    kernels, and the device-busy share.  A stage's time is the kernels its
    CPU range launched (not the range's own device annotation).  Returns
    (wall ms, device ms) a step."""
    from torch.autograd import DeviceType
    names = {f"moe{n}": g for n, g in MOE_RANGES.items()}
    torch.cuda.synchronize()
    with MoeRanges(), new_profiler(torch) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def launched(ev):
        return (sum(k.duration for k in ev.kernels if k.name not in names)
                + sum(launched(ch) for ch in ev.cpu_children))

    groups = dict.fromkeys(("expert products", "routing / gather / combine",
                            "attention (int8 K/V or bf16)", "SPA kernels",
                            "other kernels"), 0.0)
    for ev in prof.events():
        if ev.device_type == DeviceType.CPU and ev.name in names:
            groups[names[ev.name]] += launched(ev)
    busy = 0.0
    for ev in prof.key_averages():
        if (ev.device_type != DeviceType.CUDA or ev.key in names
                or getattr(ev, "is_user_annotation", False)):
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = ev.self_cuda_time_total
        busy += t
        if any(k in ev.key for k in ATTENTION_KEYS):
            groups["attention (int8 K/V or bf16)"] += t
        elif any(k in ev.key for k in SPA_KERNEL_KEYS):
            groups["SPA kernels"] += t
    wall_ms = wall_us / n_steps / 1e3
    if busy == 0:
        print(f"  {label} profile: the trace shows no device time")
        return wall_ms, None
    groups["other kernels"] = busy - sum(groups.values())
    print(f"  {label} profile over {n_steps} steps: {wall_ms:.2f} ms/step "
          f"wall, {busy / n_steps / 1e3:.2f} device ms/step, device busy "
          f"{busy / wall_us:.1%}")
    for name, t in groups.items():
        print(f"    {name:>28}: {t / n_steps / 1e3:8.3f} ms/step "
              f"({t / busy:.1%} of device time)")
    return wall_ms, busy / n_steps / 1e3


def _cut_setup(torch, name: str, layers: int, *, device=None):
    """A config cut to its first ``layers`` layers (full widths), random
    bf16 weights from seed 0, its ``SPACache`` and SVD proxies."""
    from repro_torch.configs import get_arch
    from repro_torch.core.strategy import SPACache
    from repro_torch.models import transformer
    from repro_torch.training.optimizer import tree_leaves
    full = get_arch(name)
    cfg = dataclasses.replace(full, n_layers=layers)
    t0 = time.perf_counter()
    params = transformer.init_params(cfg, seed=0, device=device)
    strat = SPACache.from_spec(cfg.spa)
    proxies = strat.build_proxies(params, cfg)
    _sync(torch, device)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    print(f"  {name}: {layers} of {full.n_layers} layers, "
          f"{nbytes / 1e9:.1f} GB of {cfg.param_dtype} weights, d="
          f"{cfg.d_model}, {cfg.n_heads} q heads on {cfg.n_kv_heads} kv "
          f"heads of {cfg.head_dim}, cache {cfg.cache_dtype}, r="
          f"{cfg.spa.rank}"
          + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
             f"d_ff {cfg.moe.d_ff_expert}" if cfg.moe else "")
          + f"; weights and proxies {time.perf_counter() - t0:.2f} s")
    return cfg, params, strat, proxies


def _sync(torch, device=None):
    if (device or "cuda") != "cpu":
        torch.cuda.synchronize()


def _free(torch, device=None):
    """Collect cycles (a session's wrapped step refers back to it) before
    the cache is emptied, so a freed model's memory returns at once."""
    gc.collect()
    if (device or "cuda") != "cpu":
        torch.cuda.empty_cache()


def spa_then_nocache(torch, label, cfg, params, strat, proxies, prompt,
                     gen: int, *, extras=None, device=None):
    """``DecodeSession`` on ``CudaBackend``: prefill, ``MOE_SPA_STEPS`` SPA
    steps (timed), a profiled window of 4 SPA steps, then
    ``MOE_NOCACHE_STEPS`` timed ``NoCache`` steps.  Asserts finite hidden
    states, the path's kernels launched, one attention call a layer at
    prefill and a step, an int8 cache where the config has one.  Returns
    (launches, SPA ms a step, NoCache ms a step, dropped assignments a
    SPA step)."""
    from repro_torch.core import spa_layer
    from repro_torch.core.strategy import NoCache
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.kernels import _lib
    from repro_torch.models import moe

    layers = cfg.n_layers
    n = prompt.shape[1] + gen + (0 if extras is None
                                 else extras["patches"].shape[1])
    print(f"    per-layer k at N={n}: {spa_layer.layer_ks(cfg, strat, n)}")
    _lib.reset_launch_counts()
    sess = DecodeSession(params, cfg, strategy=strat, backend="cuda",
                         spa_proxies=proxies, device=device)
    _sync(torch, device)
    t0 = time.perf_counter()
    with moe.count_drops() as pre_drops:
        sess.prefill(prompt, gen, extras=extras)
    _sync(torch, device)
    t_prefill = time.perf_counter() - t0
    at_prefill = _lib.launch_counts()
    t0 = time.perf_counter()
    with moe.count_drops() as drops:
        _, info = sess.run(MOE_SPA_STEPS)
    _sync(torch, device)
    t_run = time.perf_counter() - t0
    launches = _lib.launch_counts()
    steps = info["steps"]
    assert steps == MOE_SPA_STEPS, f"{label} ran {steps} steps"
    assert bool(sess.last_info["row_finite"].all()), f"{label}: non-finite"
    on_card = (device or "cuda") != "cpu"
    if on_card:
        for kname in DENSE_KERNELS:
            assert launches[kname] > 0, \
                f"{label}: kernel {kname} never launched"
        key = attention_key(cfg)
        per_step = (launches[key] - at_prefill[key]) / steps
        assert at_prefill["sparse_attention"] == layers, at_prefill
        assert per_step == layers, (key, per_step)
    kind = cfg.layer_pattern[0]
    if cfg.cache_dtype == "int8":
        assert sess.state.cache[kind]["k"].dtype == torch.int8
    dropped = float(sum(int(d) for d in drops)) / steps if drops else 0.0
    pre = sum(int(d) for d in pre_drops)
    del drops, pre_drops
    spa_ms = t_run / steps * 1e3
    b = prompt.shape[0]
    committed = int((sess.state.tokens[:, prompt.shape[1]:]
                     != cfg.mask_id).sum())
    print(f"    SPA: prefill {t_prefill:.3f} s, {steps} steps in "
          f"{t_run:.3f} s, {spa_ms:.2f} ms/step; committed {committed} of "
          f"{b * gen} slots"
          + (f"; assignments dropped to capacity: {pre} at prefill (of "
             f"{b * n * cfg.moe.top_k * layers}), {dropped:.1f} a SPA step"
             if cfg.moe else ""))
    spa_dev = None
    if on_card:
        _, spa_dev = moe_profile(torch, sess.step, 4, f"{label} SPA")
    del sess
    _free(torch, device)
    base = DecodeSession(params, cfg, strategy=NoCache(), backend="cuda",
                         device=device)
    base.prefill(prompt, gen, use_cache=False, extras=extras)
    base.step()
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(MOE_NOCACHE_STEPS):
        base.step()
    _sync(torch, device)
    base_ms = (time.perf_counter() - t0) / MOE_NOCACHE_STEPS * 1e3
    assert bool(base.last_info["row_finite"].all()), f"{label} NoCache"
    print(f"    NoCache: {base_ms:.2f} ms/step over {MOE_NOCACHE_STEPS} "
          f"steps; SPA/NoCache wall {spa_ms / base_ms:.3f}"
          + (f"; SPA device {spa_dev:.2f} ms/step" if spa_dev else ""))
    del base
    _free(torch, device)
    return launches, spa_ms, base_ms, dropped


def moe_determinism(torch, cfg, params, *, device=None):
    """Layer 0's MoE FFN on a seeded bf16 input of the prefill's shape
    (B=4, T=512): two calls give the same bits (the combine's adds do not
    depend on thread order), and the combine equals a plain sum of each
    token's k rows in the order of its experts' indices."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import layer_params
    bp = layer_params(params, cfg, 0)["moe"]
    gen = torch.Generator().manual_seed(29)
    x = torch.randn((4, 512, cfg.d_model), generator=gen).to(
        params["embed"].dtype).to(params["embed"].device)
    outs = [moe.apply_moe(bp, x, cfg.moe, cfg.act)[0] for _ in range(2)]
    assert torch.equal(outs[0], outs[1]), "MoE: two calls differ"
    t, k = x.shape[1], cfg.moe.top_k
    slots, gates, ranks, _ = moe._dispatch(bp["router"], x, cfg.moe,
                                           moe._capacity(t, cfg.moe))
    eo = moe._experts(bp, moe._gather(x, slots), gates, cfg.act)
    got = moe._combine(eo, slots, ranks, t, k)
    want = torch.zeros_like(got)
    flat = eo.reshape(-1, eo.shape[-1])
    for r in range(k):            # each token's rank-r row, a plain add
        sel = torch.zeros(want.shape[:2], dtype=torch.long,
                          device=x.device) - 1
        b_i, e_i, c_i = torch.nonzero((slots < t) & (ranks == r),
                                      as_tuple=True)
        sel[b_i, slots[b_i, e_i, c_i]] = (
            (b_i * eo.shape[1] + e_i) * eo.shape[2] + c_i)
        rows = torch.where(sel[..., None] >= 0, flat[sel.clamp(min=0)],
                           torch.zeros((), dtype=flat.dtype,
                                       device=x.device))
        want = want + rows
    assert torch.equal(got, want), "MoE: the combine's sums differ"
    print(f"    {cfg.name} MoE layer 0 at B=4, T=512: two calls bit for "
          f"bit, the combine equal to the plain sum in expert order")


def moe_serving(torch, cfg, params, strat, proxies, *, device=None):
    """18(b): the MoE cut through ``ServingEngine``: paged lanes of pages
    of 16, prefix index on, ``MOE_SERVE``'s three prompts, then (once they
    are done, so the first has published its pages) a repeat of the first.
    Every request completes with no [MASK] left, the repeat is a full hit
    and decodes the first request's tokens, and the paged kernels
    launched."""
    import numpy as np
    from repro_torch.kernels import _lib
    from repro_torch.models import moe
    from repro_torch.serving.engine import ServingEngine

    c = MOE_SERVE
    n_pages = c["canvas"] // PAGE
    engine = ServingEngine(cfg, params, max_batch=c["slots"],
                           canvas_len=c["canvas"], strategy=strat,
                           pool_pages=2 * c["slots"] * n_pages + 1,
                           page_size=PAGE, prefix_cache=True, device=device)
    engine._proxies[engine.strategy] = proxies
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, cfg.vocab_size - 1, p).astype(np.int32)
               for p in c["prompts"]]
    _lib.reset_launch_counts()
    with moe.count_drops() as drops:
        _, wall = _serve(engine, [(p, c["gen"]) for p in prompts])
        outs, wall2 = _serve(engine, [(prompts[0], c["gen"])])
    wall += wall2
    stats = engine.stats
    assert stats.requests_done == 4, f"18(b): {stats.requests_done} done"
    for r in engine.done:
        assert not (np.asarray(r.output) == cfg.mask_id).any(), \
            f"18(b): uid {r.uid} left a mask"
    assert stats.prefix_full_hits >= 1, "18(b): the repeat never hit"
    by_uid = [outs[uid] for uid in sorted(outs)]
    assert by_uid[3] == by_uid[0], "18(b): the repeat decoded other tokens"
    launches = _lib.launch_counts()
    if (device or "cuda") != "cpu":
        for name in SERVING_KERNELS + (attention_key(cfg),):
            assert launches[name] > 0, f"18(b): {name} never launched"
    print(f"  served 4 requests in {stats.steps} engine steps, "
          f"{wall / stats.steps * 1e3:.2f} ms an engine step (wall "
          f"{wall:.2f} s), swaps {stats.swaps}, prefix hits "
          f"{stats.prefix_hits} ({stats.prefix_full_hits} full), the repeat "
          f"equal to the first request; assignments dropped to capacity "
          f"{sum(int(d) for d in drops) / stats.steps:.1f} an engine step "
          f"(admissions' prefills included)")
    del engine
    _free(torch, device)
    return launches


def moe_phase(torch, card: str, *, device=None, layers: int = MOE_CUT):
    """Phase 18: (a) each MoE config's first ``layers`` layers decoding
    (``spa_then_nocache``), (b) Qwen3-MoE's cut served (``moe_serving``),
    (c) InternVL2-76B's first ``layers`` layers decoding 1024 patch
    embeddings + prompt 256 + gen 256.  Each model is freed before the
    next."""
    for name, b, p_len in MOE:
        t0 = time.perf_counter()
        print(f"  18(a) {name} (bf16, CudaBackend, its spa, B={b}, prompt "
              f"{p_len} + gen {MOE_GEN}, {MOE_SPA_STEPS} SPA + "
              f"{MOE_NOCACHE_STEPS} NoCache steps; {card})")
        cfg, params, strat, proxies = _cut_setup(torch, name, layers,
                                                 device=device)
        gen = torch.Generator().manual_seed(19)
        prompt = torch.randint(0, cfg.vocab_size - 1, (b, p_len),
                               generator=gen)
        spa_then_nocache(torch, name, cfg, params, strat, proxies, prompt,
                         MOE_GEN, device=device)
        moe_determinism(torch, cfg, params, device=device)
        if name.startswith("qwen3"):
            c = MOE_SERVE
            print(f"  18(b) {name}'s {layers} layers through ServingEngine "
                  f"(paged, pages of {PAGE}, prefix index on, canvas "
                  f"{c['canvas']}, {c['slots']} slots, prompts "
                  f"{c['prompts']} + a repeat of the first, gen {c['gen']};"
                  f" {card})")
            moe_serving(torch, cfg, params, strat, proxies, device=device)
        del params, proxies
        _free(torch, device)
        print(f"    {name}: {time.perf_counter() - t0:.1f} s")
    v = VLM
    t0 = time.perf_counter()
    print(f"  18(c) {v['name']} (bf16, CudaBackend, its spa, B={v['b']}, "
          f"{v['patches']} patch embeddings + prompt {v['prompt']} + gen "
          f"{MOE_GEN}; {card})")
    cfg, params, strat, proxies = _cut_setup(torch, v["name"], layers,
                                             device=device)
    gen = torch.Generator().manual_seed(23)
    prompt = torch.randint(0, cfg.vocab_size - 1, (v["b"], v["prompt"]),
                           generator=gen)
    patches = (torch.randn((v["b"], v["patches"], cfg.d_model),
                           generator=gen) * 0.02).to(
        params["embed"].dtype).to(params["embed"].device)
    spa_then_nocache(torch, v["name"], cfg, params, strat, proxies, prompt,
                     MOE_GEN, extras={"patches": patches}, device=device)
    del params, proxies, patches
    _free(torch, device)
    print(f"    {v['name']}: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# Phase 19: training on the card
# ---------------------------------------------------------------------------

TRAIN_FULL = dict(batch=8, seq=512, steps=6)          # InternLM2-1.8B
TRAIN_TINY = dict(vocab_size=64, d_model=64, n_layers=2, d_ff=128, steps=200,
                  batch=8, seq=32)                   # the JAX test_system
TRAIN_MOE = dict(batch=8, seq=256, steps=2)          # Qwen3-MoE, 1 layer
TRAIN_AUDIO = dict(batch=4, seq=1024, steps=4)       # HuBERT-XLarge


def train_steps(torch, cfg, batch: int, seq: int, steps: int, label: str,
                *, device=None):
    """``steps`` AdamW steps (the default schedule: its warmup keeps these
    first steps' updates small) of ``cfg`` (random weights from seed 0) on
    synthetic batches (seed 0) with the masking from a seeded generator,
    on ``TorchBackend``: no kernel launches, finite loss and gradient
    norm, no step skipped.  Prints each step's loss, ms a step (after the
    first), tokens a second and peak device memory.  Returns (params,
    metrics of the last step)."""
    from repro_torch.data.synthetic import token_batches
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer
    from repro_torch.training.optimizer import (AdamWConfig, init_opt_state,
                                                tree_leaves)
    from repro_torch.training.trainer import batch_to_device, train_step

    on_card = (device or "cuda") != "cpu"
    dev = torch.device(device or "cuda")
    _free(torch, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    params = transformer.init_params(cfg, seed=0, device=dev)
    opt = init_opt_state(params)
    data = token_batches(cfg, batch, seq, seed=0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    opt_cfg = AdamWConfig()
    _lib.reset_launch_counts()
    times, losses, m = [], [], None
    for _ in range(steps):
        b = batch_to_device(next(data), dev)
        _sync(torch, device)
        t0 = time.perf_counter()
        params, opt, m = train_step(params, opt, b, gen, cfg=cfg,
                                    opt_cfg=opt_cfg)
        _sync(torch, device)
        times.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"]), \
            f"{label}: loss {float(m['loss'])}, grad norm " \
            f"{float(m['grad_norm'])}"
        assert float(m["nonfinite_grads"]) == 0, f"{label}: a step skipped"
    assert not any(_lib.launch_counts().values()), \
        f"{label}: training launched a kernel"
    ms = statistics.median(times[1:] or times) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 30 if on_card else 0.0
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"    {label}: {n_params / 1e9:.3f} B parameters, B={batch}, "
          f"seq {seq}, microbatches {max(cfg.microbatch, 1)}, remat "
          f"{cfg.remat}: {steps} steps, first {times[0] * 1e3:.1f} ms, then "
          f"{ms:.1f} ms a step (median), {batch * seq / ms * 1e3:,.0f} "
          f"tokens/s, losses {[round(x, 4) for x in losses]}, last grad "
          f"norm {float(m['grad_norm']):.3f}, peak {peak:.1f} GiB")
    return params, m


def tiny_recipe(torch, *, device=None):
    """19(b): the JAX ``tests/test_system.py`` recipe on the card: the tiny
    reduced InternLM2 trained 200 steps (mean of the last 5 losses below
    the first 5's), then decoded through the CUDA kernels: SPA at the
    paper's budget agrees with vanilla on more than 60% of tokens and
    computes fewer rows."""
    import numpy as np
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import SPAConfig
    from repro_torch.core import budget, spa_layer
    from repro_torch.core.strategy import SPACache
    from repro_torch.data.synthetic import token_batches
    from repro_torch.dlm import decoding
    from repro_torch.kernels import _lib
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import Trainer

    c = TRAIN_TINY
    cfg = reduced(get_arch("internlm2-1.8b"), vocab_size=c["vocab_size"],
                  d_model=c["d_model"], n_layers=c["n_layers"],
                  d_ff=c["d_ff"])
    tr = Trainer(cfg, AdamWConfig(lr=3e-3, warmup_steps=5,
                                  total_steps=220),
                 device=device or "cuda").init(0)
    t0 = time.perf_counter()
    hist = tr.fit(token_batches(cfg, c["batch"], c["seq"], seed=0),
                  n_steps=c["steps"], seed=1, log_every=0)
    wall = time.perf_counter() - t0
    first, last = np.mean(hist["loss"][:5]), np.mean(hist["loss"][-5:])
    print(f"    trained {c['steps']} steps in {wall:.2f} s "
          f"({wall / c['steps'] * 1e3:.2f} ms a step): mean loss of the "
          f"first 5 {first:.4f}, of the last 5 {last:.4f}")
    assert last < first, f"19(b): the loss did not fall ({first}, {last})"
    params = tr.params
    prompt = torch.from_numpy(next(token_batches(cfg, 2, 8, seed=4))[
        "tokens"])
    cfg_spa = dataclasses.replace(cfg, spa=SPAConfig(
        identifier="singular", rank=16, schedule="adaptive",
        rho_peak=0.5, rho_first=0.2, rho_last=0.3))
    cfg_v = dataclasses.replace(cfg, spa=SPAConfig(identifier="none"))
    _lib.reset_launch_counts()
    t_spa, _ = decoding.decode(params, cfg_spa, prompt, gen_len=10,
                               device=device)
    spa_launches = _lib.launch_counts()
    t_v, _ = decoding.decode(params, cfg_v, prompt, gen_len=10,
                             device=device)
    assert int((t_spa == cfg.mask_id).sum()) == 0
    agree = float((t_spa == t_v).float().mean())
    n = prompt.shape[1] + 10
    ks = spa_layer.layer_ks(cfg_spa, SPACache.from_spec(cfg_spa.spa), n)
    adaptive = SPAConfig(identifier="singular", rank=16, schedule="adaptive",
                         rho_peak=0.25, rho_first=0.05, rho_last=0.1)
    uniform = SPAConfig(identifier="singular", rank=16, schedule="uniform",
                        rho_peak=0.25)
    ks_a = budget.k_schedule(adaptive, cfg.n_layers, 4096)
    ks_u = budget.k_schedule(uniform, cfg.n_layers, 4096)
    print(f"    decode (CudaBackend, gen 10): SPA agrees with vanilla on "
          f"{agree:.1%} of tokens; SPA ks {ks} of N={n} a layer; at N=4096 "
          f"adaptive {sum(ks_a)} rows against uniform {sum(ks_u)}; SPA "
          f"launches {({k: v for k, v in spa_launches.items() if v})}")
    if (device or "cuda") != "cpu":
        for kname in DENSE_KERNELS:
            assert spa_launches[kname] > 0, f"19(b): {kname} never launched"
    assert agree > 0.6, f"19(b): SPA agrees with vanilla on {agree:.1%}"
    assert sum(ks) < cfg.n_layers * n and sum(ks_a) < sum(ks_u)


def training_phase(torch, card: str, *, device=None, full_layers=None):
    """Phase 19: (a) InternLM2-1.8B at full width and depth, (b) the tiny
    recipe, (c) Qwen3-MoE at full width with 1 layer (the aux loss in the
    total), (d) HuBERT-XLarge at full depth through ``encoder_loss``.
    ``full_layers`` (a CPU rehearsal) cuts (a) and (d)."""
    from repro_torch.configs import get_arch

    def cut(cfg, layers):
        return cfg if layers is None else dataclasses.replace(
            cfg, n_layers=layers)

    c = TRAIN_FULL
    print(f"  19(a) internlm2-1.8b, AdamW on TorchBackend ({card})")
    cfg = cut(get_arch("internlm2-1.8b"), full_layers)
    params, _ = train_steps(torch, cfg, c["batch"], c["seq"], c["steps"],
                            "internlm2-1.8b", device=device)
    del params
    _free(torch, device)
    print(f"  19(b) the tiny recipe ({card})")
    tiny_recipe(torch, device=device)
    c = TRAIN_MOE
    cfg = dataclasses.replace(get_arch("qwen3-moe-235b-a22b"), n_layers=1)
    print(f"  19(c) qwen3-moe-235b-a22b, 1 layer at full width ({card})")
    params, m = train_steps(torch, cfg, c["batch"], c["seq"], c["steps"],
                            "qwen3-moe-235b-a22b/1", device=device)
    aux, ce = float(m["aux"]), float(m["ce"])
    assert aux > 0, "19(c): no aux loss"
    total = ce + cfg.moe.router_aux_weight * aux
    assert abs(float(m["loss"]) - total) <= 1e-5 * max(1.0, abs(total)), \
        f"19(c): loss {float(m['loss'])} is not ce + w * aux = {total}"
    print(f"    aux {aux:.4f} (x {cfg.moe.router_aux_weight}) in the total "
          f"{float(m['loss']):.4f} = ce {ce:.4f} + w * aux")
    del params, m
    _free(torch, device)
    c = TRAIN_AUDIO
    print(f"  19(d) hubert-xlarge, encoder_loss ({card})")
    cfg = cut(get_arch("hubert-xlarge"), full_layers)
    params, _ = train_steps(torch, cfg, c["batch"], c["seq"], c["steps"],
                            "hubert-xlarge", device=device)
    del params
    _free(torch, device)


# ---------------------------------------------------------------------------
# Phase 20: the dry run, the sharding rules and the hill-climb tools
# ---------------------------------------------------------------------------

DRYRUN_ARCH = "internlm2-1.8b"
DRYRUN_COMBOS = (("decode_32k", "single"), ("train_4k", "single"),
                 ("decode_32k", "multi"))
DRYRUN_HOST = dict(B=4, N=4096)     # 20(c): a decode step one card holds
HILLCLIMB_DIR = Path(__file__).resolve().parent / "build" / "hillclimb20"


def spec_arg_bytes(dryrun, shd, abs_args, in_sh, mesh) -> int:
    """Sum of every argument leaf's local shard, from its spec alone (the
    rules' arithmetic, not the traced tensors)."""
    total = 0

    def add(leaf, spec):
        nonlocal total
        spec = tuple(spec or ()) + (None,) * (leaf.dim() - len(spec or ()))
        n = 1
        for size in shd.local_shape(tuple(leaf.shape), spec, mesh):
            n *= size
        total += n * leaf.element_size()
        return leaf

    for a, s in zip(abs_args, in_sh):
        if a != "generator":
            dryrun._zip_map(add, a, s)
    return total


def print_record(rec: dict, card: str) -> None:
    mem = rec["memory"]
    coll = ", ".join(f"{k} {v['count']:.0f}x {v['bytes'] / 2**20:.1f} MiB"
                     for k, v in rec["collectives"].items() if v["count"])
    print(f"    [{rec['arch']} x {rec['shape']} x {rec['mesh']}] "
          f"{rec['status']}, {rec['n_chips']} ranks; per device "
          f"{mem['per_device_total_gb']} GB of 80 (args "
          f"{mem['argument_bytes'] / 2**30:.3f} GiB, temp "
          f"{mem['temp_bytes'] / 2**30:.3f} GiB); FLOPs "
          f"{rec['hlo_flops_per_device']:.4g}, useful "
          f"{rec.get('useful_flop_ratio')}; collectives "
          f"{coll or 'none'}; compute {rec['t_compute_s'] * 1e3:.3f} ms, "
          f"memory {rec['t_memory_s'] * 1e3:.3f} ms, collective "
          f"{rec['t_collective_s'] * 1e3:.3f} ms -> {rec['bottleneck']}; "
          f"built in {rec['lower_s']} s, traced in {rec['compile_s']} s "
          f"({card})")


def dryrun_phase(torch, card: str, device: str = "cuda") -> None:
    """Phase 20 (see the module docstring)."""
    import shutil

    from repro_torch.configs import SHAPES, get_arch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, hillclimb
    from repro_torch.launch import mesh as mesh_lib
    arch = DRYRUN_ARCH
    cfg = get_arch(arch)

    print(f"  20(a) {arch}, fake CUDA tensors on the production meshes")
    for shape_name, mesh_kind in DRYRUN_COMBOS:
        rec = dryrun.run_one(arch, shape_name, mesh_kind, verbose=False,
                             cfg_override=cfg, device=device)
        assert rec["status"] == "ok", rec
        mesh = mesh_lib.make_production_mesh(
            multi_pod=mesh_kind == "multi", device_type=device)
        _, abs_args, in_sh, _, _ = dryrun.BUILDERS[SHAPES[shape_name].kind](
            cfg, SHAPES[shape_name], mesh)
        want = spec_arg_bytes(dryrun, shd, abs_args, in_sh, mesh)
        mesh_lib.destroy_mesh()
        print_record(rec, card)
        assert rec["memory"]["argument_bytes"] == want, \
            f"20(a): argument bytes {rec['memory']['argument_bytes']} != " \
            f"the specs' local shards {want}"
        assert rec["collective_bytes_per_device"] > 0, \
            f"20(a): no collectives on the {mesh_kind} mesh"

    print(f"  20(b) hillclimb on {arch} / decode_32k (store under "
          f"build/)")
    shutil.rmtree(HILLCLIMB_DIR, ignore_errors=True)
    HILLCLIMB_DIR.mkdir(parents=True)
    store, out = HILLCLIMB_DIR / "profiles.json", HILLCLIMB_DIR / "hc.jsonl"
    recs = {}
    for i, variant in enumerate(("baseline", "int8_cache", "baseline")):
        t0 = time.perf_counter()
        argv = ["--arch", arch, "--shape", "decode_32k", "--variant",
                variant, "--profile-store", str(store), "--out", str(out),
                "--device", device]
        assert hillclimb.main(argv) == 0
        rec = json.loads(out.read_text().splitlines()[-1])
        recs[(variant, i)] = rec
        print(f"    {variant}: {rec['memory']['per_device_total_gb']} GB "
              f"a device, {rec['bottleneck']}, warm start "
              f"{rec.get('warm_start', False)} "
              f"({time.perf_counter() - t0:.1f} s)")
    base, q, again = (recs[("baseline", 0)], recs[("int8_cache", 1)],
                      recs[("baseline", 2)])
    assert "warm_start" not in base and "warm_start" not in q
    assert q["memory"]["per_device_total_gb"] < \
        base["memory"]["per_device_total_gb"], "20(b): int8 holds no less"
    assert again.get("warm_start") is True, "20(b): no warm start"

    host = DRYRUN_HOST
    print(f"  20(c) {arch} decode at B={host['B']}, N={host['N']} on the "
          f"1 x 1 host mesh, then for real ({card})")
    dryrun_vs_card(torch, cfg, host, card, device)


def dryrun_vs_card(torch, cfg, host, card: str, device: str) -> None:
    """20(c): the dry run of one decode step against the same step on the
    card (``CudaBackend``) and through ``TorchBackend`` under
    ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.strategy import resolve_strategy
    from repro_torch.dlm import decoding
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.kernels import _lib
    from repro_torch.launch import dryrun, hlo_cost
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import transformer

    b, n = host["B"], host["N"]
    shape = ShapeConfig("decode_host", n, b, "decode")
    mesh = mesh_lib.make_host_mesh(device)
    fn, abs_args, in_sh, donate, out_sh = dryrun.build_decode(cfg, shape,
                                                              mesh)
    res = dryrun.trace_step(fn, abs_args, in_sh, donate, out_sh, mesh,
                            torch.device(device),
                            dryrun.act_batch_axes(cfg, shape, mesh))
    terms = dryrun.roofline_terms(res, cfg, shape, mesh)
    mesh_lib.destroy_mesh()
    mem = res["memory"]
    print(f"    dry run: args {mem['argument_bytes'] / 2**30:.3f} GiB, "
          f"peak {(mem['argument_bytes'] + mem['temp_bytes']) / 2**30:.3f}"
          f" GiB, FLOPs {res['flops']:.6g}, compute "
          f"{terms['t_compute_s'] * 1e3:.3f} ms + memory "
          f"{terms['t_memory_s'] * 1e3:.3f} ms (traced in "
          f"{res['compile_s']:.1f} s)")

    gen = torch.Generator().manual_seed(20)
    params = transformer.init_params(cfg, seed=20, device=device)
    strat = resolve_strategy(cfg, None)
    proxies = {k: (torch.randn(t.shape, generator=gen) / t.shape[1] ** 0.5
                   ).to(device=device, dtype=t.dtype)
               for k, t in (dryrun.spa_proxy_specs(cfg, strat) or {}).items()}
    prompt = torch.randint(0, cfg.vocab_size - 1, (b, n // 2),
                           generator=gen)
    sess = DecodeSession(params, cfg, strategy=strat, backend="cuda",
                         spa_proxies=proxies, device=device)
    st = sess.prefill(prompt, n - n // 2)
    live = dryrun._unique_bytes([params, st.tokens, st.cache, st.committed,
                                 st.n_masked, st.active, proxies])
    print(f"    real params, state and proxies: {live / 2**30:.3f} GiB")
    assert live == mem["argument_bytes"], \
        f"20(c): argument bytes {mem['argument_bytes']} != live {live}"

    settings = decoding.DecodeSettings(n_candidates=64,
                                       parallel_threshold=0.9,
                                       max_parallel=8)
    cuda_strat = strat.with_backend("cuda")
    step = lambda: decoding.serve_step(params, cfg, sess.state, settings,
                                       proxies, strategy=cuda_strat)
    step()                                   # warm-up (and any build)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _lib.reset_launch_counts()
    step()
    launches = _lib.launch_counts()
    wall_ms, dev_ms = profile_steps(torch, step, 3, "20(c) CudaBackend")
    if device != "cpu":
        peak = torch.cuda.max_memory_allocated()
        for name in SESSION_KERNELS:
            assert launches[name] > 0, f"20(c): {name} never launched"
        print(f"    launches in one step: "
              f"{ {k: launches[k] for k in SESSION_KERNELS} }")
        pred = mem["argument_bytes"] + mem["temp_bytes"]
        t_pred = (terms["t_compute_s"] + terms["t_memory_s"]) * 1e3
        print(f"    predicted peak / card's peak: {pred / 2**30:.3f} / "
              f"{peak / 2**30:.3f} GiB = {pred / peak:.3f}; predicted "
              f"compute + memory / card's device ms: {t_pred:.3f} / "
              f"{dev_ms if dev_ms is None else round(dev_ms, 3)} ms"
              + ("" if not dev_ms else f" = {t_pred / dev_ms:.3f}")
              + f"; wall {wall_ms:.3f} ms a step ({card})")

    torch_strat = strat.with_backend("torch")
    with FlopCounterMode(display=False) as fc:
        decoding.serve_step(params, cfg, sess.state, settings, proxies,
                            strategy=torch_strat)
    counted = fc.get_total_flops()
    print(f"    FLOPs: dry run {res['flops']:.6g}, FlopCounterMode through "
          f"TorchBackend {counted:.6g}")
    assert res["flops"] == counted, \
        f"20(c): dry-run FLOPs {res['flops']} != counted {counted}"
    del sess, st, params, proxies
    _free(torch, device)


ALL_PHASES = tuple(range(3, 21))


START = time.perf_counter()
SECONDS = {}              # phase -> wall seconds (17: its parts summed)


@contextlib.contextmanager
def timed(phase, part: str = ""):
    """Print the phase's (or its part's) wall seconds when it ends."""
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    SECONDS[phase] = SECONDS.get(phase, 0.0) + dt
    print(f"  phase {phase}{part}: {dt:.1f} s")


def parse_phases(argv) -> tuple:
    """``--phases 3,6,7`` runs only those of phases 3-20 (the card line and
    the build always run) and prints no result line: for development
    calls and for comparing two trees' kernels in one call.  Without it,
    every phase runs."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated subset of phases 3-20")
    phases = tuple(sorted({int(p) for p in ap.parse_args(argv).phases
                           .split(",") if p}))
    if not phases or not set(phases) <= set(ALL_PHASES):
        ap.error(f"phases must lie in 3-20, got {phases}")
    return phases


def main(argv=None) -> int:
    phases = parse_phases(sys.argv[1:] if argv is None else argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")

    print("build")
    _lib.load()
    print(f"  kernels built in {_lib.build_seconds():.1f} s")
    (_lib.BUILD_DIR / "nvcc.log").write_text(_lib.build_log())
    entry = "?"
    for line in _lib.build_log().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]  # the mangled name
        elif "registers" in line or "spill" in line:
            print(f"  {entry}: {line.strip()}")

    flush = L2Flush(torch)
    records = {}
    if 3 in phases:
        with timed(3):
            records = check_kernels(torch, flush)
    if 4 in phases:
        with timed(4):
            decode_parity_phase(torch)
    launches = base = lanes = served = {}
    if {5, 6, 7, 12, 14, 15, 16, 17} & set(phases):
        print(f"LLaDA-8B (bf16, B=4, prompt 256 + gen {GEN_LEN}; phases "
              f"5-7, 12 and 14-17; 32 layers in 5 and 16, the first "
              f"{CUT_LAYERS} in 6, 7, 12, 14, 15 and 17(a))")
        cfg, params, strat, proxies = llada_setup(torch)
        cut = llada_cut(cfg, params, proxies)
        if 5 in phases:
            print(f"main path (LLaDA-8B bf16, B=4, prompt 256 + gen "
                  f"{GEN_LEN})")
            with timed(5):
                launches = main_path(torch, cfg, params, strat, proxies)
            torch.cuda.empty_cache()
        if 6 in phases:
            print(f"baselines (LLaDA-8B bf16, {CUT_LAYERS} layers, B=4, "
                  f"prompt 256 + gen {GEN_LEN}, the config's adaptive "
                  f"budget)")
            with timed(6):
                base = baselines(torch, cut[0], cut[1], cut[3], cut[2])
            for name in BASELINE_KERNELS:
                assert base[name] > 0, \
                    f"kernel {name} never launched (baselines)"
        if 7 in phases:
            print(f"server at full width (LLaDA-8B bf16, {CUT_LAYERS} "
                  f"layers, through ServingEngine, canvas 512, pool of 97 "
                  f"pages of {PAGE}, 4 slots)")
            with timed(7):
                paging_cost(torch, *cut)
                served = serve_full_width(torch, *cut)
                for name in SERVING_KERNELS:
                    assert served[name] > 0, \
                        f"kernel {name} never launched serving"
                print("server drift lanes (paged attn_in, incremental "
                      "singular, attn_out)")
                lanes = serve_drift_lanes(torch, cut[0], cut[1], cut[3])
            for name in DRIFT_LANE_KERNELS:
                assert lanes[name] > 0, \
                    f"kernel {name} never launched (lanes)"
        if 12 in phases:        # shares LLaDA-8B's weights and proxies
            with timed(12):
                print(f"prefix parity (2-layer full-width f32 LLaDA through "
                      f"ServingEngine, canvas {PREFIX_SMALL['canvas']}, "
                      f"pages of {PAGE}, prefix index on and off)")
                prefix_parity(torch)
                torch.cuda.empty_cache()
                c = PREFIX_FULL
                print(f"prefix serving (LLaDA-8B bf16, {CUT_LAYERS} layers, "
                      f"through ServingEngine, canvas {c['canvas']}, pages "
                      f"of {PAGE}, {c['slots']} slots, system prompt "
                      f"{c['system']} + {c['questions']} questions of "
                      f"{c['question']} asked twice, gen {c['gen']}; "
                      f"{card})")
                prefix_serving(torch, *cut)
        if 14 in phases:        # shares LLaDA-8B's weights and proxies
            with timed(14):
                c = HIER_SMALL
                print(f"host tier exactness (2-layer full-width f32 LLaDA "
                      f"through ServingEngine, canvas {c['canvas']}, pages "
                      f"of {PAGE}, pool {c['pool']}, host tier f32)")
                hier_exactness(torch)
                c = HIER
                print(f"host tier serving (LLaDA-8B bf16, {CUT_LAYERS} "
                      f"layers, through ServingEngine with the prefix "
                      f"index, canvas {c['canvas']}, pool {c['pool']} pages "
                      f"of {PAGE}, {c['slots']} slots, {HIER_STEPS} steps a "
                      f"request; tier off, f32, auto; {card})")
                hier_serving(torch, *cut)
        if 15 in phases:        # shares LLaDA-8B's weights and proxies
            with timed(15):
                online_serving(torch, *cut, card)
        if 16 in phases:        # shares LLaDA-8B's weights and proxies
            with timed(16):
                faults_phase(torch, cfg, params, strat, proxies, card)
        if 17 in phases:        # shares LLaDA-8B's weights and proxies
            c = PROFILE17
            print(f"profiling through the server (LLaDA-8B bf16, "
                  f"{CUT_LAYERS} layers, ServingEngine on CudaBackend, "
                  f"canvas {c['canvas']}, {c['pool']} pages of {PAGE}, "
                  f"{c['slots']} slots, {len(c['requests'])} requests, "
                  f"StepProfiler off and on; phase probes at B="
                  f"{PROBES17['batch']}, N={PROBES17['seq']}, k="
                  f"{PROBES17['n_selected']}; {card})")
            with timed(17, "(a)"):
                profiling_serving(torch, *cut)
        # the cut's tensors are views of the whole model: no name may keep
        # one, or the whole model's storage stays on the card
        del cfg, params, strat, proxies, cut
        _free(torch)
    int8_path = {}
    if 13 in phases:
        print(f"dense configs at full width (bf16, CudaBackend, each "
              f"config's spa, {DENSE_SPA_STEPS} SPA + {DENSE_NOCACHE_STEPS}"
              f" NoCache steps; {card})")
        with timed(13):
            int8_path = dense_configs(torch)
    hybrid = mamba = {}
    if 8 in phases:
        print("hybrid decode parity (3-layer full-width RecurrentGemma, "
              f"B=2, N={HYBRID['N']}, CudaBackend vs TorchBackend)")
        with timed(8):
            hybrid_parity(torch)
    kept = None
    if 9 in phases:
        print(f"hybrid main path (RecurrentGemma-9B bf16, B=2, prompt "
              f"{HYBRID['N'] - HYBRID_GEN} + gen {HYBRID_GEN}, "
              f"{HYBRID_STEPS} SPA steps)")
        with timed(9):
            hybrid, kept = hybrid_main_path(torch, keep=17 in phases)
        torch.cuda.empty_cache()
    if 10 in phases:
        print(f"mamba2 decode parity (3-layer full-width Mamba2, "
              f"B={MAMBA['B']}, N={MAMBA['N']}, CudaBackend vs "
              "TorchBackend)")
        with timed(10):
            mamba_parity(torch)
    if 11 in phases:
        print(f"mamba2 main path (Mamba2-370m bf16, B={MAMBA['B']}, prompt "
              f"{MAMBA['N'] - MAMBA_GEN} + gen {MAMBA_GEN}, {MAMBA_STEPS} "
              "NoCache steps)")
        with timed(11):
            mamba = mamba_main_path(torch)
    if 17 in phases:
        c = RECURRENT_SMALL
        print(f"recurrent lanes, exact (3-layer full-width RecurrentGemma and "
              f"Mamba2, f32, through ServingEngine, canvas {c['canvas']}, "
              f"{c['slots']} slots, dense and paged lanes of pages of "
              f"{c['page']} with the prefix index, CudaBackend vs "
              f"TorchBackend)")
        with timed(17, "(b)"):
            recurrent_exactness(torch)
        h, m = RECURRENT_FULL["hybrid"], RECURRENT_FULL["mamba2"]
        print(f"recurrent servers at full width (bf16, paged, pages of "
              f"{PAGE}, prefix index on; RecurrentGemma-9B's first "
              f"{HYBRID_CUT} layers at canvas {h['canvas']}, Mamba2-370m at "
              f"canvas {m['canvas']}; {h['slots']} slots, 6 requests of gen "
              f"{h['gen']} each; {card})")
        with timed(17, "(c)"):
            recurrent_full_width(torch, kept)
        del kept
        torch.cuda.empty_cache()
        print(f"  phase 17: {SECONDS[17]:.1f} s")
    if 18 in phases:
        print(f"MoE and VLM configs at full width, their first {MOE_CUT} "
              f"layers (bf16, random weights, each config's spa and int8 "
              f"cache, CudaBackend; {card})")
        with timed(18):
            moe_phase(torch, card)
    if 19 in phases:
        print(f"training on the card (AdamW, the forward and backward on "
              f"TorchBackend, random weights; {card})")
        with timed(19):
            training_phase(torch, card)
    if 20 in phases:
        print(f"the dry run, the sharding rules and the hill-climb tools "
              f"({DRYRUN_ARCH}; {card})")
        with timed(20):
            dryrun_phase(torch, card)
    print(f"script: {time.perf_counter() - START:.1f} s")
    if phases != ALL_PHASES:
        print(f"phases {phases} passed; a partial run prints no result line")
        return 0

    kernels = []
    for name, rec in records.items():
        bound_ms, bound_by = rec.pop("bound")
        path = (launches if name in SESSION_KERNELS
                else int8_path if name == "sparse_attention_int8"
                else hybrid if name in HYBRID_ONLY_KERNELS
                else mamba if name in MAMBA_KERNELS
                else base if name in BASELINE_KERNELS
                else lanes if name in DRIFT_LANE_KERNELS else served)
        kernels.append(dict(name=name, route="cuda", launches=path[name],
                            bound_ms=bound_ms, bound_by=bound_by, **rec))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
