"""Adaptive budget allocation (paper §3.4, Eq. 5) + scan-friendly bucketing.

``rho_schedule`` is the exact piecewise-Gaussian of Eq. (5); layers are
1-indexed in the paper's notation.

``bucketize`` is the JAX package's layer-scan adaptation (its DESIGN.md
§4.4): a scan over layer stacks needs a single static top-k size, so
contiguous layers are grouped into at most ``n_buckets`` segments; each
segment runs with the max k inside it.  The port has no scan but runs the
same k per layer, so both packages select the same rows. This never under-allocates (k_bucket >= k_exact per layer) and
over-allocates at most one quantization step.
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import SPAConfig


def rho_schedule(spa: SPAConfig, n_layers: int) -> np.ndarray:
    """Per-layer update ratio rho(l) for l = 1..L (returned 0-indexed)."""
    L = n_layers
    if spa.schedule == "uniform" or L == 1:
        return np.full(L, spa.rho_peak, dtype=np.float64)
    lp = min(spa.resolved_layer_peak(L), L)
    rho_p = spa.rho_peak
    rho_1 = min(spa.rho_first, rho_p)
    rho_L = min(spa.rho_last, rho_p)
    out = np.empty(L, dtype=np.float64)
    for l in range(1, L + 1):
        if l <= lp:
            denom = max(lp - 1, 1)
            out[l - 1] = rho_p * math.exp(
                math.log(max(rho_1, 1e-9) / rho_p)
                * ((l - lp) / denom) ** 2)
        else:
            denom = max(L - lp, 1)
            out[l - 1] = rho_p * math.exp(
                math.log(max(rho_L, 1e-9) / rho_p)
                * ((l - lp) / denom) ** 2)
    return out


def k_schedule(spa: SPAConfig, n_layers: int, seq_len: int,
               multiple: int = 16) -> List[int]:
    """Static per-layer update counts k(l) = ceil(rho(l) * N), >= 1.

    Rounded UP to a multiple of 16 (when seq_len permits) so the selected
    rows shard evenly over the "model" axis (row-parallel sparse
    pipeline, EXPERIMENTS.md §Perf) — a tiny over-provision, never
    under-budget."""
    rhos = rho_schedule(spa, n_layers)
    ks = [max(1, int(math.ceil(r * seq_len))) for r in rhos]
    if seq_len >= multiple:
        ks = [min(seq_len, ((k + multiple - 1) // multiple) * multiple)
              for k in ks]
    return ks


def average_rho(spa: SPAConfig, n_layers: int) -> float:
    return float(np.mean(rho_schedule(spa, n_layers)))


def bucketize(ks: Sequence[int], n_buckets: int
              ) -> List[Tuple[int, int, int]]:
    """Split layers into <= n_buckets contiguous segments.

    Returns [(start, stop, k_seg)] with k_seg = max(ks[start:stop]).
    Segment boundaries are chosen greedily at the largest relative jumps of
    the (unimodal) k-curve, which minimizes over-provisioning in practice.
    """
    L = len(ks)
    n_buckets = max(1, min(n_buckets, L))
    if n_buckets == 1:
        return [(0, L, max(ks))]
    # Rank interior boundaries by |log k[i] - log k[i-1]|.
    jumps = [(abs(math.log(ks[i]) - math.log(ks[i - 1])), i)
             for i in range(1, L)]
    jumps.sort(reverse=True)
    cuts = sorted({i for _, i in jumps[: n_buckets - 1]})
    bounds = [0] + cuts + [L]
    return [(a, b, max(ks[a:b])) for a, b in zip(bounds[:-1], bounds[1:])]


def over_provision_ratio(ks: Sequence[int],
                         segments: Sequence[Tuple[int, int, int]]) -> float:
    """sum(bucketized k) / sum(exact k) — 1.0 means no waste."""
    exact = sum(ks)
    bucketed = sum(kseg * (b - a) for a, b, kseg in segments)
    return bucketed / max(exact, 1)
