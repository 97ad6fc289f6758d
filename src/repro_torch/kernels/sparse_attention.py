"""Phase-2 kernel: gathered-query attention against the KV cache.

Replaces both grids of ``repro/kernels/sparse_attention.py:
sparse_attention``: the dense grid (``_dense_kernel`` -> ``_attn_step``)
and the banded grid (``_banded_kernel``).  Queries at
arbitrary positions ``q_pos`` attend to every cached key with an f32
online softmax: GQA (kv head = q head // G), the scale applied after the
QK dot, optional ``soft_cap * tanh``, masks for per-row ``kv_len`` and
``|q_pos - kv_pos| <= window``, int8 K/V with per-row f32-cast scales,
``NEG_INF = -1e30``, ``alpha = 0`` while the running max is still at
``NEG_INF``, masked probabilities forced to 0 and ``l == 0`` rows output 0.

The same function serves prefill (contiguous ``q_pos = arange``), so the
port has one attention implementation and no library call.

Banded grid (``banded`` with a ``q_span`` bound, windowed layers on a long
canvas, where :func:`banded_engages` holds, as in the JAX kernel): the
queries form JAX q blocks of ``bq = min(512, kq)`` and the keys kv blocks
of ``bk = min(512, N)``; q block ``i`` visits only the ``n_band =
band_width(q_span, window, bk, n_kb)`` kv blocks from ``starts[i] =
banded_starts(...)`` (the start is the minimum over the whole ``[B, bq]``
tile, so the batch rows share it).  Keys outside that range are dropped
even where the window would admit them (a q block wider than ``q_span``),
exactly as in JAX; where the band covers the window the result is the
dense grid's.

``sparse_attention_plain`` is the block-structured PyTorch version
(``flash_attention``'s kv-block loop, ``block_k = 512``, per q block on the
banded grid); the wrapper takes it for CPU tensors and launches
``csrc/sparse_attention.cu`` for CUDA ones, counted as
``sparse_attention`` (dense grid) or ``sparse_attention_banded``.  On the
card, bf16 K/V take any head_dim that is a multiple of 8 up to 256 (padded
with zero columns to the kernel's next width) and no scales; other bf16
shapes raise.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib

NEG_INF = -1e30
BLOCK_Q = 512          # the JAX q block (the banded grid's start unit)
BLOCK_K = 512          # the JAX kv block; selects the banded condition
Band = Tuple[torch.Tensor, int, int]   # (starts [n_qb] int32, n_band, bq)


def _deq(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    xf = x.float()
    if scale is not None:
        xf = xf * scale.float()[..., None]
    return xf


def sparse_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, q_pos: torch.Tensor, *,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           window: int = 0, soft_cap: float = 0.0,
                           kv_len: Optional[torch.Tensor] = None,
                           block_k: int = BLOCK_K,
                           band: Optional[Band] = None) -> torch.Tensor:
    """q: [B, kq, H, hd]; k/v: [B, N, KVH, hd]; q_pos: [B, kq];
    k_scale/v_scale: [B, N, KVH] or None; kv_len: [B] or None.
    ``band`` (from :func:`band_for`) runs the banded grid: q block ``i``
    (``bq`` queries) sees only kv blocks ``starts[i] .. starts[i] + n_band
    - 1``.  Returns [B, kq, H, hd] in q.dtype."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    assert h % kvh == 0, (h, kvh)
    bk = min(block_k, skv)
    qr = q.reshape(b, sq, kvh, h // kvh, d).float()
    qpos = q_pos.long()
    if band is None:
        out = _attend_plain(qr, qpos, k, v, k_scale, v_scale, 0, skv, bk,
                            window, soft_cap, kv_len)
    else:
        starts, n_band, bq = band
        outs = []
        for i, st in enumerate(starts.tolist()):
            q0, q1 = i * bq, min((i + 1) * bq, sq)
            lo = st * bk
            outs.append(_attend_plain(
                qr[:, q0:q1], qpos[:, q0:q1], k, v, k_scale, v_scale, lo,
                min(skv, lo + n_band * bk), bk, window, soft_cap, kv_len))
        out = torch.cat(outs, dim=1)
    return out.reshape(b, sq, h, d).to(q.dtype)


def _attend_plain(qr, qpos, k, v, k_scale, v_scale, kv_lo: int, kv_hi: int,
                  bk: int, window: int, soft_cap: float, kv_len):
    """Online softmax of qr [B, sq, KVH, G, hd] (f32) over the keys
    [kv_lo, kv_hi) in blocks of bk.  Returns [B, sq, KVH, G, hd] f32."""
    b, sq, kvh, g, d = qr.shape
    scale = 1.0 / (d ** 0.5)
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=qr.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=qr.device)
    acc = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32,
                      device=qr.device)
    for s0 in range(kv_lo, kv_hi, bk):
        s1 = min(s0 + bk, kv_hi)
        kf = _deq(k[:, s0:s1], None if k_scale is None
                  else k_scale[:, s0:s1])
        vf = _deq(v[:, s0:s1], None if v_scale is None
                  else v_scale[:, s0:s1])
        scores = torch.einsum("bqhgd,bkhd->bqhgk", qr, kf) * scale
        if soft_cap > 0.0:
            scores = soft_cap * torch.tanh(scores / soft_cap)
        kpos = torch.arange(s0, s1, device=qr.device)
        mask = torch.ones((b, sq, s1 - s0), dtype=torch.bool,
                          device=qr.device)
        if kv_len is not None:
            mask = mask & (kpos[None, None, :] < kv_len.long()[:, None, None])
        if window > 0:
            mask = mask & ((qpos[:, :, None] - kpos[None, None, :]).abs()
                           <= window)
        mask5 = mask[:, :, None, None, :]
        scores = torch.where(mask5, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # masked entries enter exp as 0, not as -1e30 (the CPU's exp is
        # several times slower where it underflows); they are zeroed below
        p = torch.exp(torch.where(mask5, scores - m_new[..., None], 0.0))
        p = torch.where(mask5, p, 0.0)
        alpha = torch.exp(m - m_new)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, alpha)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bqhgk,bkhd->bqhgd",
                                                    p, vf)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    return acc / l_safe[..., None]


def banded_engages(n: int, window: int, banded: bool, q_span: int,
                   block_k: int = BLOCK_K) -> bool:
    """The JAX kernel's banded-grid condition (``sparse_attention.py``)."""
    bk = min(block_k, n)
    return (banded and window > 0 and q_span > 0
            and n > q_span + 2 * window + 2 * bk)


def band_width(q_span: int, window: int, block_k: int, n_kb: int) -> int:
    """Number of kv blocks a banded q block must visit (static)."""
    return min((q_span + 2 * window) // block_k + 2, n_kb)


def banded_starts(qpos_r: torch.Tensor, window: int, skv_p: int,
                  n_band: int, block_k: int) -> torch.Tensor:
    """First kv-block index per q block for the banded grid.

    qpos_r: [B, n_qb, bq] padded query positions (pad value >= 2**30).
    The start is per q BLOCK: the minimum over the whole [B, bq] tile.
    Pads never win the minimum; an all-pad block clips to the last valid
    start (its rows are discarded).  Returns [n_qb] int32."""
    pmin = qpos_r.amin(dim=(0, 2)).long()
    start = torch.clamp(pmin - window, 0, skv_p - n_band * block_k)
    return torch.div(start, block_k, rounding_mode="floor").to(torch.int32)


def band_for(q_pos: torch.Tensor, n: int, window: int, q_span: int, *,
             banded: bool = True, block_q: int = BLOCK_Q,
             block_k: int = BLOCK_K) -> Optional[Band]:
    """The banded grid's (starts, n_band, bq) for q_pos [B, kq], with the
    JAX kernel's padding (pad positions 2^30) and formulas; None where
    the banded grid does not engage (:func:`banded_engages`)."""
    if not banded_engages(n, window, banded, q_span, block_k):
        return None
    b, kq = q_pos.shape
    bq, bk = min(block_q, kq), min(block_k, n)
    n_qb, n_kb = -(-kq // bq), -(-n // bk)
    qp = torch.nn.functional.pad(q_pos.to(torch.int32),
                                 (0, n_qb * bq - kq), value=2 ** 30)
    n_band = band_width(q_span, window, bk, n_kb)
    starts = banded_starts(qp.reshape(b, n_qb, bq), window, n_kb * bk,
                           n_band, bk)
    return starts, n_band, bq


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     window: int = 0, soft_cap: float = 0.0,
                     banded: bool = False, q_span: int = 0,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gathered-query attention, dense or banded grid (module docstring)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    n = k.shape[1]
    band = band_for(q_pos, n, window, q_span, banded=banded)
    if q.device.type == "cpu":
        return sparse_attention_plain(q, k, v, q_pos, k_scale=k_scale,
                                      v_scale=v_scale, window=window,
                                      soft_cap=soft_cap, kv_len=kv_len,
                                      band=band)
    _lib.require_cuda(q, k, v, q_pos, k_scale, v_scale, kv_len)
    b, kq, h, hd = q.shape
    kvh = k.shape[2]
    if (k.shape != (b, n, kvh, hd) or v.shape != k.shape
            or q_pos.shape != (b, kq) or h % kvh):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, q_pos {tuple(q_pos.shape)}")
    if hd > 256:
        raise ValueError(f"attention kernel takes head_dim <= 256, got {hd}")
    quant = k.dtype == torch.int8
    if quant:
        if v.dtype != torch.int8 or k_scale is None:
            raise TypeError("int8 K/V need int8 v and per-row scales")
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("float K/V must share q's dtype")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    q_pos = q_pos.to(torch.int32).contiguous()
    ks = vs = None
    if k_scale is not None:
        if k_scale.shape != (b, n, kvh) or v_scale.shape != (b, n, kvh):
            raise ValueError("scales must be [B, N, KVH]")
        ks = k_scale.to(torch.float32).contiguous()
        vs = v_scale.to(torch.float32).contiguous()
    if q.dtype == torch.bfloat16 and not quant:
        # bf16 K/V run only on the wgmma body
        if hd % 8 or ks is not None:
            raise ValueError("bf16 K/V attention takes a head_dim that is a "
                             "multiple of 8 and no scales, got head_dim "
                             f"{hd}, scales {ks is not None}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("bf16 K/V attention needs 16-byte aligned "
                             "q, k and v")
    kvl = None if kv_len is None else kv_len.to(torch.int32).contiguous()
    starts, n_band, bq = (None, 0, 0) if band is None else band
    if starts is not None:
        starts = starts.to(torch.int32).contiguous()
    out = torch.empty((b, kq, h, hd), dtype=q.dtype, device=q.device)
    lib = _lib.load()
    _lib.check(lib.spa_sparse_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(),
        None if kvl is None else kvl.data_ptr(), out.data_ptr(),
        b, kq, h, n, kvh, hd, _lib.dtype_code(q.dtype), int(quant),
        int(window), 1.0 / (hd ** 0.5), float(soft_cap),
        None if starts is None else starts.data_ptr(), n_band, bq,
        min(BLOCK_K, n), _lib.stream_ptr(q)), "sparse_attention")
    _lib.LAUNCHES["sparse_attention" if band is None
                  else "sparse_attention_banded"] += 1
    return out
