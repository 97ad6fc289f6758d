"""SPA-Cache state + int8 cache quantization (the dense half).

Per attention layer the cache holds (Algorithm 1):
  k, v      — the partially-updated KV cache          [B, N, KVH, HD]
  h         — the block OUTPUT states H^c             [B, N, d]
  proxy     — identifier vectors at the last refresh  [B, N, r]
  proxy_now — every row's CURRENT identifier vector   [B, N, r]
              (incremental identifiers only: only the rows whose inputs
              changed are re-projected each step)

Layers are stacked per layer kind ({kind: {name: [Lk, B, N, ...]}}).  The
JAX package returns new cache arrays from every write; the port writes the
buffers IN PLACE (one copy of a multi-GB cache, no donation needed).  So a
tensor that aliases a cache buffer changes under later writes: readers
that keep a value (``read_h_full``) return a copy.

int8 mode (``cache_dtype="int8"``): symmetric per-row quantization with a
float16 scale, as in the JAX package.

Paged layout (paged serving): cache rows live in ONE pooled arena of
fixed-size pages per buffer, {kind: {name: [Lk, P, page, ...]}}, and a
per-request page table maps logical canvas pages to physical pages.
Physical page 0 is the zero page: never written, and every logical page
past a row's ``kv_len`` maps to it.  A step gathers every buffer but the
identifier pages into a dense view, runs on it and scatters it back; the
identifier pages stay paged and are read and committed through the page
table (``proxy_now``, where there is one, is a dense-view buffer like
``h``).  Arenas, too, are written in place.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ATTENTION_KINDS, ModelConfig
from repro_torch.device import torch_dtype


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the last axis. Returns (q [.., d] i8, scale f16).

    The rowwise multiply stays in x's dtype, as in the JAX package."""
    amax = torch.amax(torch.abs(x), dim=-1).float()
    scale = torch.clamp(amax / 127.0, min=1e-8)
    inv = (1.0 / scale).to(x.dtype)
    q = torch.clamp(torch.round((x * inv[..., None]).float()),
                    -127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


@dataclasses.dataclass(frozen=True)
class CachePolicy:
    quantized: bool
    compute_dtype: torch.dtype

    @classmethod
    def from_config(cls, cfg: ModelConfig) -> "CachePolicy":
        return cls(quantized=(cfg.cache_dtype == "int8"),
                   compute_dtype=torch_dtype(cfg.param_dtype))


def init_attn_layer_cache(cfg: ModelConfig, batch: int, n: int,
                          policy: CachePolicy, strategy=None, *,
                          device=None) -> Dict[str, torch.Tensor]:
    """Zeros cache for ONE attention layer (no leading L axis)."""
    from repro_torch.core.strategy import resolve_strategy
    strategy = resolve_strategy(cfg, strategy)
    kvh, hd, d = cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    r = strategy.proxy_dim(cfg)
    cd = policy.compute_dtype

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    out: Dict[str, torch.Tensor] = {}
    if policy.quantized:
        out["k"] = z((batch, n, kvh, hd), torch.int8)
        out["v"] = z((batch, n, kvh, hd), torch.int8)
        out["h"] = z((batch, n, d), torch.int8)
        out["k_scale"] = z((batch, n, kvh), torch.float16)
        out["v_scale"] = z((batch, n, kvh), torch.float16)
        out["h_scale"] = z((batch, n), torch.float16)
    else:
        out["k"] = z((batch, n, kvh, hd), cd)
        out["v"] = z((batch, n, kvh, hd), cd)
        out["h"] = z((batch, n, d), cd)
    if r:
        out["proxy"] = z((batch, n, r), cd)
        if strategy.incremental:
            out["proxy_now"] = z((batch, n, r), cd)
    return out


def init_model_cache(cfg: ModelConfig, batch: int, n: int, strategy=None,
                     *, device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Stacked caches per attention kind: {kind: {name: [Lk, B, N, ...]}}."""
    policy = CachePolicy.from_config(cfg)
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for kind in sorted(set(cfg.layer_kinds)):
        if kind not in ATTENTION_KINDS:
            continue
        lk = cfg.n_layers_of_kind(kind)
        one = init_attn_layer_cache(cfg, batch, n, policy, strategy,
                                    device=device)
        out[kind] = {name: a[None].repeat((lk,) + (1,) * a.dim())
                     for name, a in one.items()}
    return out


# ---------------------------------------------------------------------------
# Paged layout
# ---------------------------------------------------------------------------

class PagedCache(NamedTuple):
    """Paged cache state: pooled arenas + the batch page table.

    arenas:     {kind: {name: [Lk, P, page, ...]}}
    page_table: [B, n_log] int32 physical page per logical canvas page
    """
    arenas: Dict[str, Dict[str, torch.Tensor]]
    page_table: torch.Tensor


# Buffers that stay PAGED through the layer loop (identification reads and
# row commits go through the page table); every other buffer is gathered
# into a dense view per step (attention reads all of K/V anyway).
PAGED_IN_STEP = ("proxy",)


def n_logical_pages(canvas_len: int, page_size: int) -> int:
    if canvas_len % page_size:
        raise ValueError(
            f"canvas_len {canvas_len} must be a multiple of page_size "
            f"{page_size}")
    return canvas_len // page_size


def init_paged_arenas(cfg: ModelConfig, n_pages: int, page_size: int,
                      strategy=None, *, device=None
                      ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Zeroed pooled arenas {kind: {name: [Lk, n_pages, page, ...]}}: the
    buffer set of :func:`init_model_cache` with (batch, n) replaced by
    (physical pages, page rows); page 0 is the zero page."""
    return init_model_cache(cfg, n_pages, page_size, strategy,
                            device=device)


def paged_step_view(pc: PagedCache, backend=None
                    ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-step compute view of a paged cache: every buffer except the
    ``PAGED_IN_STEP`` set is gathered dense through the page table; the
    identifier arenas are passed as they are."""
    if backend is None:
        from repro_torch.kernels.backend import TORCH_BACKEND as backend
    return {kind: {name: (arena if name in PAGED_IN_STEP
                          else backend.gather_pages(arena, pc.page_table))
                   for name, arena in bufs.items()}
            for kind, bufs in pc.arenas.items()}


def paged_step_commit(pc: PagedCache, view: Dict[str, Dict[str, torch.Tensor]],
                      backend=None) -> PagedCache:
    """Scatter a stepped view back into the arenas, in place (zero-page
    writes drop, so short rows' tails stay zero).  Returns ``pc``."""
    if backend is None:
        from repro_torch.kernels.backend import TORCH_BACKEND as backend
    for kind, bufs in pc.arenas.items():
        for name, arena in bufs.items():
            if name not in PAGED_IN_STEP:
                backend.scatter_pages(arena, pc.page_table, view[kind][name])
    return pc


def paged_from_dense(arenas: Dict[str, Dict[str, torch.Tensor]],
                     page_table: torch.Tensor,
                     dense: Dict[str, Dict[str, torch.Tensor]],
                     backend=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """Scatter a dense cache ([Lk, B, N, ...], a prefill's output) into the
    arenas through the page table, in place, EVERY buffer including the
    identifier pages.  ``page_table`` may cover a sub-batch (row swap).
    Returns ``arenas``."""
    if backend is None:
        from repro_torch.kernels.backend import TORCH_BACKEND as backend
    for kind, bufs in arenas.items():
        for name, arena in bufs.items():
            backend.scatter_pages(arena, page_table, dense[kind][name])
    return arenas


def repage(arenas: Dict[str, Dict[str, torch.Tensor]],
           page_table: torch.Tensor,
           dense: Dict[str, Dict[str, torch.Tensor]], backend=None,
           full_table: Optional[torch.Tensor] = None) -> PagedCache:
    """Scatter a freshly built dense cache into the arenas and wrap them as
    a :class:`PagedCache`: the one repage protocol of attach, refresh and
    row swaps (``page_table`` may cover a sub-batch; ``full_table`` is then
    the whole batch's table to carry)."""
    return PagedCache(
        paged_from_dense(arenas, page_table, dense, backend),
        page_table if full_table is None else full_table)


def scatter_buffers(cache: Dict[str, torch.Tensor], idx: torch.Tensor,
                    upd: Dict[str, torch.Tensor],
                    backend=None) -> Dict[str, torch.Tensor]:
    """Scatter row payloads ``upd`` [B,k,...] into the named cache buffers
    at idx, in place, through the KernelBackend (ONE multi-buffer kernel
    launch on ``CudaBackend``).  Quantization happens before this."""
    if backend is None:
        from repro_torch.kernels.backend import TORCH_BACKEND as backend
    backend.scatter_multi({name: cache[name] for name in upd}, idx, upd)
    return cache


def h_row_update(h_rows: torch.Tensor, policy: CachePolicy
                 ) -> Dict[str, torch.Tensor]:
    """Row payloads for an H^c commit ({"h"[, "h_scale"]})."""
    if policy.quantized:
        hq, hs = quantize_rows(h_rows)
        return {"h": hq, "h_scale": hs}
    return {"h": h_rows}


def write_kv(cache: Dict[str, torch.Tensor], idx: torch.Tensor,
             k_rows: torch.Tensor, v_rows: torch.Tensor,
             policy: CachePolicy, backend=None) -> Dict[str, torch.Tensor]:
    """Scatter new K/V rows ([B,k,KVH,HD]) into the layer cache at idx."""
    if policy.quantized:
        kq, ks = quantize_rows(k_rows)
        vq, vs = quantize_rows(v_rows)
        upd = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        upd = {"k": k_rows, "v": v_rows}
    return scatter_buffers(cache, idx, upd, backend)


def write_h(cache: Dict[str, torch.Tensor], idx: torch.Tensor,
            h_rows: torch.Tensor, policy: CachePolicy,
            backend=None) -> Dict[str, torch.Tensor]:
    return scatter_buffers(cache, idx, h_row_update(h_rows, policy),
                           backend)


def read_kv_for_attention(cache: Dict[str, torch.Tensor],
                          policy: CachePolicy):
    """Returns (k, v, k_scale, v_scale) for the attention stage."""
    if policy.quantized:
        return (cache["k"], cache["v"], cache["k_scale"], cache["v_scale"])
    return (cache["k"], cache["v"], None, None)


def read_h_full(cache: Dict[str, torch.Tensor], policy: CachePolicy,
                dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The layer's H^c as a NEW tensor (never an alias of the buffer,
    which later commits overwrite in place)."""
    dtype = dtype or policy.compute_dtype
    if policy.quantized:
        return dequantize_rows(cache["h"], cache["h_scale"], dtype)
    return cache["h"].to(dtype, copy=True)


def fill_from_prefill(entries: Dict[str, torch.Tensor],
                      policy: CachePolicy, incremental: bool = False
                      ) -> Dict[str, torch.Tensor]:
    """Build one kind's cache dict from raw prefill tensors [Lk, B, N, ...].
    ``entries`` must be fresh stacks (``forward_hidden`` builds them with
    ``torch.stack``): a cast to the dtype they already have keeps them.
    ``incremental`` adds ``proxy_now``, a copy of ``proxy`` (its own
    buffer: the two are written in place independently)."""
    out: Dict[str, torch.Tensor] = {}
    if policy.quantized:
        out["k"], out["k_scale"] = quantize_rows(entries["k"])
        out["v"], out["v_scale"] = quantize_rows(entries["v"])
        out["h"], out["h_scale"] = quantize_rows(entries["h"])
    else:
        cd = policy.compute_dtype
        for name in ("k", "v", "h"):
            out[name] = entries[name].to(cd)
    if "proxy" in entries:
        out["proxy"] = entries["proxy"].to(policy.compute_dtype)
        if incremental:
            out["proxy_now"] = out["proxy"].clone()
    return out
