"""Hand-written Hopper kernels of the SPA hot path (CUDA C++ in ``csrc/``).

  proxy_score      — fused rank-r projection + cosine drift scores (dense
                     or through a page table; a projection kernel first
                     above rank 256), the projection-free
                     ``cosine_drift`` (dense or paged), and
                     ``gather_norm``, the fused gather + rms_norm epilogue
  sparse_attention — gathered-query attention vs the KV cache (dense
                     grid, and the banded grid of windowed layers on a
                     long canvas; also serves prefill)
  rglru_scan       — the RG-LRU linear recurrence (a chunked scan)
  ssd_chunk        — the Mamba-2 SSD chunked scan (state [hd, ds] per head)
  scatter_update   — in-place multi-buffer row commits, and the paged
                     cache copies (gather/scatter pages, paged row commits)

Each module keeps the plain PyTorch version beside its kernel.
``backend.py`` packages them as ``TorchBackend`` (plain) and
``CudaBackend`` (kernels); ``_lib.py`` builds and binds the library.
"""
