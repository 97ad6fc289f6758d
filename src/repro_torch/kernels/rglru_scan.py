"""The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t``.

Replaces ``repro/kernels/rglru_scan.py:rglru_scan`` (the Pallas kernel that
streams the sequence through VMEM with an f32 carry).  The JAX model never
calls that kernel: its ``rglru_core`` runs ``linear_recurrence``, an XLA
associative scan inside chunks.  The port has no XLA, so here this kernel
IS the recurrence of ``models.rglru.rglru_core``.

Elementwise over channels, along axis 1 of ``[B, T, d]``, with an f32
carry from zero; every step rounds ``a_t * h`` and then ``+ b_t`` to f32
(as the JAX reference ``a_t * h + b_t``), and the output is cast to a's
dtype.  ``rglru_scan_plain`` is the sequential loop over T; the wrapper
takes it for CPU tensors and launches ``csrc/rglru_scan.cu`` (one pass
over chunks of 64 steps with a decoupled look-back, see its note) for CUDA
ones.  The kernel agrees with the plain version to f32 rounding of the
chunk carries, and gives the same bits on every run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: [B, T, d] -> h [B, T, d] in a.dtype (sequential, f32 carry)."""
    af, bf = a.float(), b.float()
    out = torch.empty_like(af)
    h = torch.zeros_like(af[:, 0])
    ah = torch.empty_like(h)
    for t in range(a.shape[1]):
        torch.mul(af[:, t], h, out=ah)
        h = torch.add(ah, bf[:, t], out=out[:, t])
    return out.to(a.dtype)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: [B, T, d], one dtype (f32 or bf16) -> h [B, T, d] in a.dtype
    with ``h_t = a_t * h_{t-1} + b_t`` (see module docstring)."""
    if a.shape != b.shape or a.dim() != 3:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must "
                         "be one [B, T, d] shape")
    if a.device.type == "cpu" and b.device.type == "cpu":
        return rglru_scan_plain(a, b)
    _lib.require_cuda(a, b)
    if b.dtype != a.dtype:
        raise TypeError(f"a is {a.dtype}, b is {b.dtype}: pass one dtype")
    code = _lib.dtype_code(a.dtype)
    a, b = a.contiguous(), b.contiguous()
    bsz, t, d = a.shape
    out = torch.empty_like(a)
    lib = _lib.load()
    # the tile counter and the chunks' carries (filled on the stream)
    ws = torch.empty(lib.spa_rglru_workspace_bytes(bsz, t, d),
                     dtype=torch.uint8, device=a.device)
    _lib.check(lib.spa_rglru_scan(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), ws.data_ptr(), bsz, t, d,
        code, _lib.stream_ptr(a)), "rglru_scan")
    _lib.LAUNCHES["rglru_scan"] += 1
    return out
