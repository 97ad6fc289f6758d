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
   mask), and the attention body's ``-Xptxas -v`` line.  Before every
   timed call the L2 is left holding only clean lines (``L2Flush``), and
   for the timing floor and six kernel rows the time under the earlier,
   dirty ``zero_()`` flush is printed beside it;
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
   lines; the row movers (``check_row_movers``): the timing floor (a
   one-element kernel), scatter_update_multi at every commit of the
   layer step beyond its record's LLaDA K+V k=128 (k=16, H + proxy, int8
   K+V + scales, int8 H + 2-byte scale + proxy; the hybrid's 512-byte
   K+V rows and H + proxy at k=4096) bit for bit, and gather_norm beyond
   its record's k=128 (LLaDA k=16, the hybrid's k=4096 and 720, f32,
   d=1000 / 120), each timed beside its bound and plain version (scatter
   also beside ``index_copy_``), with their ``-Xptxas -v`` lines;
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
6. the baselines: the same decode under each baseline strategy (the
   config's adaptive budget; value and the incremental identifier to
   completion, the others for 64 steps), ms/step and generated tokens/s
   each, a ``torch.profiler`` window on each; hidden states finite, the
   path's new kernels launched; then all of them and SPA side by side in
   rotating blocks (wall ms/step comparable within the call);
7. what paging costs a step (the main path's decode on a dense cache and
   on the pool, in turns), then the server: the same model and proxies
   through ``ServingEngine`` over
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
   1e-5 of their largest value, bf16 in lockstep;
11. the Mamba2 main path: Mamba2-370m (48 SSD layers, bf16, random
   weights), B=4, prompt 3840 + gen 256, ``DecodeSession.run`` with the
   config's ``NoCache`` and ``CudaBackend`` for 32 steps: exactly two
   ssd_chunk_scan launches a layer a step, hidden states finite, ms/step,
   generated tokens/s and a profiled window (cuBLAS, ssd_chunk_scan, other
   kernels, device-busy share).

Every profiled window (phases 5, 6, 7, 9, 11) prints each kernel group's
device ms a step, calls a step and device us a call.

The last lines are the kernels' JSON record (each kernel's launches are
those of its path: phase 5 for the session kernels, phase 6 for
cosine_drift and the wide proxy_score, phase 7's first server for the
paged kernels and its drift lanes for cosine_drift_paged, phase 9 for
the banded grid and rglru_scan, phase 11 for ssd_chunk_scan), the card
line and ``{"ok": true, "device": {...}}``.  Without a CUDA device, or without
the repository's ``src/`` beside it, the script exits non-zero before
printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
    ``zero_()`` of a 64 MB buffer alone (``dirty=True``, the flush of
    earlier runs, kept to compare with them) left the L2 full of dirty
    lines, and a call that read X bytes then also wrote back up to X dirty
    bytes between its events.  The read sweep of a second 64 MB buffer (a
    sum into a preallocated scalar) evicts those lines before the timed
    call's spin kernel starts."""

    def __init__(self, torch):
        self.torch = torch
        self.written = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                   device="cuda")
        self.swept = torch.ones(16 * 2 ** 20, dtype=torch.float32,
                                device="cuda")
        self.total = torch.zeros((), dtype=torch.float32, device="cuda")

    def __call__(self, dirty: bool = False) -> None:
        self.written.zero_()
        if not dirty:
            self.torch.sum(self.swept, 0, out=self.total)


def median_ms(fn, torch, flush, runs: int = 30, warmup: int = 3,
              dirty: bool = False) -> float:
    """Median device time of one call, from CUDA events.  ``flush`` (an
    :class:`L2Flush`) runs before every timed call, so inputs come from
    HBM and the L2 holds no dirty line (``dirty=True``: the earlier
    ``zero_()`` flush alone), and a spin kernel ahead of the start event
    keeps the card busy while the host enqueues the call, so the events
    bracket device work and not Python dispatch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        flush(dirty)
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def both_flushes(label: str, fn, torch, flush, **kw) -> float:
    """:func:`median_ms` under the clean flush, printed beside the same
    call under the earlier dirty one; returns the clean time."""
    clean = median_ms(fn, torch, flush, **kw)
    dirty = median_ms(fn, torch, flush, dirty=True, **kw)
    print(f"  {label}: {clean:.4f} ms (dirty flush {dirty:.4f} ms)")
    return clean


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
    """``-Xptxas -v`` of the bf16 attention body, one entry per head_dim
    width: registers, stack and spills (from the build log)."""
    widths = ptxas_lines(r"attention_bf16_wgmmaILi(\d+)E")
    return "; ".join(f"hd {w}: " + ", ".join(v)
                     for w, v in sorted(widths.items(), key=lambda kv:
                                        int(kv[0])))


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
        ms=both_flushes("slice shape kernel", lambda: ps.proxy_score(
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
        ms=both_flushes("k=128 kernel", lambda: ps.gather_norm(
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
    # f32: FMA order only, 1e-5.
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
    # body at other widths; int8 (and every f32 case) the FMA tiles.
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
        ms=both_flushes("k=128 K+V kernel", lambda: sc.scatter_update_multi(
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
    for name, rec in records.items():
        lib = ("-" if rec["library_ms"] is None
               else f"{rec['library_ms']:.4f}")
        print(f"  {name}: kernel {rec['ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms, library {lib} ms, bound "
              f"{rec['bound'][0]:.4f} ms ({rec['bound'][1]})")
    _lib.reset_launch_counts()
    return records


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
    both_flushes("a one-element add_", lambda: one.add_(1), torch, flush)
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
    records["scatter_pages"] = dict(
        source="src/repro_torch/csrc/paged.cu",
        replaces="src/repro/kernels/scatter_update.py:199", max_abs_err=0.0,
        ms=median_ms(lambda: sc.scatter_pages(back, pt, dense), torch, flush),
        plain_ms=median_ms(lambda: sc.scatter_pages_plain(back, pt, dense),
                           torch, flush),
        library_ms=None,
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
        ms=both_flushes("k=128 kernel", lambda: sc.scatter_rows_paged(
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
    inc_ms = both_flushes("f32/bf16 r=128 (incremental width) kernel",
                          lambda: ps.cosine_drift(x_inc, pc_inc), torch,
                          flush)
    inc_bound = bound(4 * B * N * r_inc + 2 * B * N * r_inc + 4 * B * N,
                      6 * B * N * r_inc, F32_FLOPS)
    print(f"  f32/bf16 r=128: kernel {inc_ms:.4f} ms, bound "
          f"{inc_bound[0]:.4f} ms ({inc_bound[1]})")
    records["cosine_drift"] = dict(
        source="src/repro_torch/csrc/proxy_score.cu",
        replaces="src/repro/kernels/proxy_score.py:138", max_abs_err=err,
        ms=both_flushes("bf16/bf16 r=4096 kernel", lambda: ps.cosine_drift(
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
    inc_ms = both_flushes(
        "f32/bf16 r=128 kernel", lambda: ps.cosine_drift_paged(
            x_inc, arena_inc, pt), torch, flush)
    print(f"  f32/bf16 r=128: kernel {inc_ms:.4f} ms, bound "
          f"{inc_bound[0]:.4f} ms ({inc_bound[1]})")
    records["cosine_drift_paged"] = dict(
        source="src/repro_torch/csrc/proxy_score.cu",
        replaces="src/repro/kernels/proxy_score.py:254", max_abs_err=err_paged,
        ms=both_flushes("bf16 r=4096 kernel", lambda: ps.cosine_drift_paged(
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
    einsums: f32 within 1e-4 of the largest output (f32 sums in another
    order), bf16 within two ulps of the largest output.  Inputs as the
    model makes them: dt = softplus(N(0,1) - 3), a = -[1..16] over the
    heads, la the in-chunk cumulative sum of dt * a."""
    import math
    from repro_torch.kernels import ssd_chunk as sc

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    B, N, H, hd, ds, cs = (MAMBA[k] for k in ("B", "N", "H", "hd", "ds",
                                              "chunk"))
    print(f"ssd_chunk_scan (x [{B}, {N}, {H}, {hd}], ds {ds}, chunk {cs})")

    def inputs(t, dtype):
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

    errs = {}
    for t, dtype in ((N, torch.bfloat16), (N, torch.float32),
                     (200, torch.bfloat16), (200, torch.float32)):
        args = inputs(t, dtype)
        got = sc.ssd_chunk_scan(*args, cs)
        want = sc.ssd_chunk_scan_plain(*args, cs).float()
        assert bool(torch.isfinite(got).all()), "non-finite ssd output"
        top = float(want.abs().max())
        lim = (1e-4 * top if dtype == torch.float32
               else 2 * 2.0 ** (math.floor(math.log2(top)) - 7))
        err = max_err(got, want)
        print(f"  {dtype} T={t}: max_abs_err {err:.3e} (limit {lim:.3e}, "
              f"max |y| {top:.3e})")
        assert err <= lim, f"ssd_chunk_scan {dtype} T={t}: {err} over {lim}"
        errs[(t, dtype)] = err
        del args, got, want
    args = inputs(N, torch.bfloat16)
    nbytes = 2 * 2 * B * N * H * hd + 2 * 2 * B * N * ds + 2 * 4 * B * N * H
    # the work the data needs: C B^T once per (batch row, chunk), then per
    # head the causal half of M X (j <= i), C S^T and X^T (w o B)
    n_chunks = N // cs
    tri = cs * (cs + 1) // 2
    flops = (2 * B * n_chunks * cs * cs * ds
             + 2 * B * n_chunks * H * (tri * hd + 2 * cs * ds * hd))
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
    from torch.autograd import DeviceType
    with new_profiler(torch) as prof:
        for _ in range(10):
            flush()
            sc.ssd_chunk_scan(*args, cs)
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and "ssd_chunk_" in ev.key:
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            print(f"  {ev.key[:60]}: {us / 10 / 1e3:.4f} ms a call")
    for name, lines in sorted(ptxas_lines(
            r"(ssd_chunk_(?:states|pass|outputs)[a-z0-9_]*(?:ILb[01]E)?)"
            ).items()):
        name = name.replace("ILb1E", "<true>").replace("ILb0E", "<false>")
        print(f"  ptxas -v {name}: {', '.join(lines)}")
    print(f"  this check took {time.perf_counter() - t0:.1f} s")
    del args
    return {"ssd_chunk_scan": rec}


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


def decode_parity(torch, cache_tol: float, setup, strat, label: str):
    """f32: a whole decode through ``CudaBackend`` and ``TorchBackend``;
    tokens and step counts must be identical, and every cache buffer must
    agree within ``cache_tol`` of its largest value."""
    from repro_torch.dlm.session import DecodeSession

    cfg, params, _, proxies, prompt = setup
    proxies = proxies if strat.uses_proxy_mat else None
    out = {}
    for name in ("cuda", "torch"):
        with oracle_launches_nothing(label, name == "torch"):
            sess = DecodeSession(params, cfg, strategy=strat, backend=name,
                                 spa_proxies=proxies)
            sess.prefill(prompt, 16)
            toks, info = sess.run()
            torch.cuda.synchronize()
        out[name] = (toks.cpu(), info["steps"], sess.state.cache)
    n_diff = int((out["cuda"][0] != out["torch"][0]).sum())
    assert n_diff == 0, \
        f"{label} float32: CudaBackend and TorchBackend differ in " \
        f"{n_diff} tokens"
    assert out["cuda"][1] == out["torch"][1], f"{label}: step counts differ"
    worst = _cache_rel_diff(out["cuda"][2], out["torch"][2])
    print(f"  {label} float32: tokens identical, steps {out['cuda'][1]}, "
          f"max cache diff {worst:.3e} of the buffer's largest value")
    assert worst <= cache_tol, f"{label}: cache buffers differ by {worst}"
    del out


def lockstep_parity(torch, logit_tol: float, cache_tol: float, setup,
                    strat, label: str, strict: bool = True):
    """bf16, the main path's kernel variants: a whole decode through
    ``CudaBackend``, and before every step ``TorchBackend`` is given a copy
    of the CUDA session's state and takes the same step.  From the same
    state, the step's candidate logits must agree within ``logit_tol`` and
    every cache buffer within ``cache_tol`` of its largest value, and the
    step's tokens must be identical.  A free-running bf16 pair is not
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
    prefill_diff = _cache_rel_diff(a.state.cache, b.state.cache)
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
                         _cache_rel_diff(a.state.cache, b.state.cache))
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
                  (("proxy_wgmma", "false"), ("proxy_score_f32", "false>"))),
                 ("proxy_score", ("proxy_wgmma", "proxy_score_f32")),
                 ("gather_norm", ("gather_norm",)),
                 ("sparse_attention (dense + banded)",
                  ("attention_bf16_wgmma", "attention_kernel")),
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
    (cfg, params, strat, proxies), shared by phases 5-7."""
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


def hybrid_main_path(torch):
    """Phase 9: RecurrentGemma-9B (38 layers, bf16, random weights), B=2,
    prompt 16128 + gen 256 (N = 16384), DecodeSession.run with SPACache,
    the confidence scheduler and CudaBackend for HYBRID_STEPS steps; then
    a profiled window and a few NoCache steps.  Returns the launches of
    the SPA run (prefill and steps)."""
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
    del base, params, proxies
    torch.cuda.empty_cache()
    return launches


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
    out = {}
    for name in ("cuda", "torch"):
        with oracle_launches_nothing("mamba2", name == "torch"):
            sess = DecodeSession(params, cfg, backend=name)
            sess.prefill(prompt, 16)
            toks, info = sess.run()
            h = transformer.embed_inputs(params, cfg, {"tokens": toks})
            h, _ = transformer.forward_hidden(
                params, cfg, h, strategy=strat.with_backend(name))
            torch.cuda.synchronize()
        out[name] = (toks.cpu(), info["steps"], h)
        if name == "cuda":
            launches = _lib.launch_counts()["ssd_chunk_scan"]
    assert launches > 0, "ssd_chunk_scan never launched (mamba2 parity)"
    n_diff = int((out["cuda"][0] != out["torch"][0]).sum())
    assert n_diff == 0, f"mamba2 float32: backends differ in {n_diff} tokens"
    assert out["cuda"][1] == out["torch"][1] == 16, "step counts differ"
    h_c, h_t = out["cuda"][2], out["torch"][2]
    h_diff = max_err(h_c, h_t) / float(h_t.abs().max())
    print(f"  mamba2 float32: tokens identical, steps {out['cuda'][1]}, "
          f"ssd_chunk_scan launches {launches}, final hidden states differ "
          f"by {h_diff:.3e} of their largest value")
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


ALL_PHASES = tuple(range(3, 12))


def parse_phases(argv) -> tuple:
    """``--phases 3,6,7`` runs only those of phases 3-11 (the card line and
    the build always run) and prints no result line: for development
    calls and for comparing two trees' kernels in one call.  Without it,
    every phase runs."""
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(map(str, ALL_PHASES)),
                    help="comma-separated subset of phases 3-11")
    phases = tuple(sorted({int(p) for p in ap.parse_args(argv).phases
                           .split(",") if p}))
    if not phases or not set(phases) <= set(ALL_PHASES):
        ap.error(f"phases must lie in 3-11, got {phases}")
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
    records = check_kernels(torch, flush) if 3 in phases else {}
    if 4 in phases:
        decode_parity_phase(torch)
    launches = base = lanes = served = {}
    if {5, 6, 7} & set(phases):
        print(f"LLaDA-8B (bf16, B=4, prompt 256 + gen {GEN_LEN})")
        cfg, params, strat, proxies = llada_setup(torch)
        if 5 in phases:
            print(f"main path (LLaDA-8B bf16, B=4, prompt 256 + gen "
                  f"{GEN_LEN})")
            launches = main_path(torch, cfg, params, strat, proxies)
            torch.cuda.empty_cache()
        if 6 in phases:
            print(f"baselines (LLaDA-8B bf16, B=4, prompt 256 + gen "
                  f"{GEN_LEN}, the config's adaptive budget)")
            base = baselines(torch, cfg, params, proxies, strat)
            for name in BASELINE_KERNELS:
                assert base[name] > 0, \
                    f"kernel {name} never launched (baselines)"
        if 7 in phases:
            print("server at full width (LLaDA-8B bf16 through "
                  f"ServingEngine, canvas 512, pool of 97 pages of {PAGE}, "
                  "4 slots)")
            paging_cost(torch, cfg, params, strat, proxies)
            served = serve_full_width(torch, cfg, params, strat, proxies)
            for name in SERVING_KERNELS:
                assert served[name] > 0, \
                    f"kernel {name} never launched serving"
            print("server drift lanes (paged attn_in, incremental singular, "
                  "attn_out)")
            lanes = serve_drift_lanes(torch, cfg, params, proxies)
            for name in DRIFT_LANE_KERNELS:
                assert lanes[name] > 0, \
                    f"kernel {name} never launched (lanes)"
        del cfg, params, strat, proxies
        torch.cuda.empty_cache()
    hybrid = mamba = {}
    if 8 in phases:
        print("hybrid decode parity (3-layer full-width RecurrentGemma, "
              f"B=2, N={HYBRID['N']}, CudaBackend vs TorchBackend)")
        hybrid_parity(torch)
    if 9 in phases:
        print(f"hybrid main path (RecurrentGemma-9B bf16, B=2, prompt "
              f"{HYBRID['N'] - HYBRID_GEN} + gen {HYBRID_GEN}, "
              f"{HYBRID_STEPS} SPA steps)")
        hybrid = hybrid_main_path(torch)
        torch.cuda.empty_cache()
    if 10 in phases:
        print(f"mamba2 decode parity (3-layer full-width Mamba2, "
              f"B={MAMBA['B']}, N={MAMBA['N']}, CudaBackend vs "
              "TorchBackend)")
        t0 = time.perf_counter()
        mamba_parity(torch)
        print(f"  phase 10: {time.perf_counter() - t0:.1f} s")
    if 11 in phases:
        print(f"mamba2 main path (Mamba2-370m bf16, B={MAMBA['B']}, prompt "
              f"{MAMBA['N'] - MAMBA_GEN} + gen {MAMBA_GEN}, {MAMBA_STEPS} "
              "NoCache steps)")
        t0 = time.perf_counter()
        mamba = mamba_main_path(torch)
        print(f"  phase 11: {time.perf_counter() - t0:.1f} s")
    if phases != ALL_PHASES:
        print(f"phases {phases} passed; a partial run prints no result line")
        return 0

    kernels = []
    for name, rec in records.items():
        bound_ms, bound_by = rec.pop("bound")
        path = (launches if name in SESSION_KERNELS
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
