"""Singular proxy construction (paper §3.3, Theorem 3.4).

Weights act by right-multiplication, v = h @ W_v with W_v [d_in, d_out].
The paper's proxy keeps the top-r left singular vectors of W_v scaled by
their singular values:

    W_v = U S V^T  =>  f_proxy(h) = h @ (U_r * S_r)

so the proxy matrix is ``U[:, :r] * S[:r]`` of shape [d_in, r], computed in
f32 and cast to the weight dtype.  The SVD is an offline artefact (the JAX
package computes it in numpy, outside any kernel); here it runs with
``torch.linalg.svd`` on whatever device holds the weights.
"""
from __future__ import annotations

import torch


def build_proxy(w_v: torch.Tensor, rank: int) -> torch.Tensor:
    """w_v: [d_in, d_out]. Returns the proxy [d_in, r] in w_v.dtype."""
    u, s, _ = torch.linalg.svd(w_v.float(), full_matrices=False)
    r = min(rank, s.shape[0])
    return (u[:, :r] * s[None, :r]).to(w_v.dtype)


def build_proxy_stack(w_v_stack: torch.Tensor, rank: int) -> torch.Tensor:
    """Proxies for stacked per-layer value weights [L, d_in, d_out]."""
    return torch.stack([build_proxy(w, rank) for w in w_v_stack])
