"""Phase-2 kernel: gathered-query attention against the whole KV cache.

Replaces the dense grid of ``repro/kernels/sparse_attention.py:
sparse_attention`` (``_dense_kernel`` -> ``_attn_step``).  Queries at
arbitrary positions ``q_pos`` attend to every cached key with an f32
online softmax: GQA (kv head = q head // G), the scale applied after the
QK dot, optional ``soft_cap * tanh``, masks for per-row ``kv_len`` and
``|q_pos - kv_pos| <= window``, int8 K/V with per-row f32-cast scales,
``NEG_INF = -1e30``, ``alpha = 0`` while the running max is still at
``NEG_INF``, masked probabilities forced to 0 and ``l == 0`` rows output 0.

The same function serves prefill (contiguous ``q_pos = arange``), so the
port has one attention implementation and no library call.  The banded
grid (windowed, n > 8192) waits for a later slice: the wrapper raises when
it would engage.

``sparse_attention_plain`` is the block-structured PyTorch version
(``flash_attention``'s kv-block loop, ``block_k = 512``); the wrapper takes
it for CPU tensors and launches ``csrc/sparse_attention.cu`` for CUDA ones.
On the card, bf16 K/V take head_dim 32, 64 or 128 (tensor-core tiles);
other bf16 shapes raise.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib

NEG_INF = -1e30
BLOCK_K = 512          # the JAX kv block; selects the banded condition


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
                           block_k: int = BLOCK_K) -> torch.Tensor:
    """q: [B, kq, H, hd]; k/v: [B, N, KVH, hd]; q_pos: [B, kq];
    k_scale/v_scale: [B, N, KVH] or None; kv_len: [B] or None.
    Returns [B, kq, H, hd] in q.dtype."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    assert h % kvh == 0, (h, kvh)
    g = h // kvh
    scale = 1.0 / (d ** 0.5)
    qr = q.reshape(b, sq, kvh, g, d).float()
    qpos = q_pos.long()
    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, d), dtype=torch.float32,
                      device=q.device)
    bk = min(block_k, skv)
    for s0 in range(0, skv, bk):
        s1 = min(s0 + bk, skv)
        kf = _deq(k[:, s0:s1], None if k_scale is None
                  else k_scale[:, s0:s1])
        vf = _deq(v[:, s0:s1], None if v_scale is None
                  else v_scale[:, s0:s1])
        scores = torch.einsum("bqhgd,bkhd->bqhgk", qr, kf) * scale
        if soft_cap > 0.0:
            scores = soft_cap * torch.tanh(scores / soft_cap)
        kpos = torch.arange(s0, s1, device=q.device)
        mask = torch.ones((b, sq, s1 - s0), dtype=torch.bool,
                          device=q.device)
        if kv_len is not None:
            mask = mask & (kpos[None, None, :] < kv_len.long()[:, None, None])
        if window > 0:
            mask = mask & ((qpos[:, :, None] - kpos[None, None, :]).abs()
                           <= window)
        mask5 = mask[:, :, None, None, :]
        scores = torch.where(mask5, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        p = torch.where(mask5, p, 0.0)
        alpha = torch.exp(m - m_new)
        alpha = torch.where(m <= NEG_INF / 2, 0.0, alpha)
        l = alpha * l + p.sum(dim=-1)
        acc = alpha[..., None] * acc + torch.einsum("bqhgk,bkhd->bqhgd",
                                                    p, vf)
        m = m_new
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = acc / l_safe[..., None]
    return out.reshape(b, sq, h, d).to(q.dtype)


def banded_engages(n: int, window: int, banded: bool, q_span: int,
                   block_k: int = BLOCK_K) -> bool:
    """The JAX kernel's banded-grid condition (``sparse_attention.py``)."""
    bk = min(block_k, n)
    return (banded and window > 0 and q_span > 0
            and n > q_span + 2 * window + 2 * bk)


def sparse_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos: torch.Tensor, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     window: int = 0, soft_cap: float = 0.0,
                     banded: bool = False, q_span: int = 0,
                     kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gathered-query attention, dense grid (see module docstring)."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    n = k.shape[1]
    if banded_engages(n, window, banded, q_span):
        raise NotImplementedError(
            "the banded sparse_attention grid (windowed, long context) is "
            "not ported yet; it waits for a later slice")
    if q.device.type == "cpu":
        return sparse_attention_plain(q, k, v, q_pos, k_scale=k_scale,
                                      v_scale=v_scale, window=window,
                                      soft_cap=soft_cap, kv_len=kv_len)
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
        # bf16 K/V run only on the tensor-core tiles
        if hd not in (32, 64, 128) or ks is not None:
            raise ValueError("bf16 K/V attention takes head_dim 32, 64 or "
                             f"128 and no scales, got head_dim {hd}, "
                             f"scales {ks is not None}")
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("bf16 K/V attention needs 16-byte aligned "
                             "q, k and v")
    kvl = None if kv_len is None else kv_len.to(torch.int32).contiguous()
    out = torch.empty((b, kq, h, hd), dtype=q.dtype, device=q.device)
    lib = _lib.load()
    _lib.check(lib.spa_sparse_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
        None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(),
        None if kvl is None else kvl.data_ptr(), out.data_ptr(),
        b, kq, h, n, kvh, hd, _lib.dtype_code(q.dtype), int(quant),
        int(window), 1.0 / (hd ** 0.5), float(soft_cap),
        _lib.stream_ptr(q)), "sparse_attention")
    _lib.LAUNCHES["sparse_attention"] += 1
    return out
