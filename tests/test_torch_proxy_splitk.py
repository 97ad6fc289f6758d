"""The numerics of the bf16 ``proxy_score`` kernel (``csrc/proxy_score.cu``,
``proxy_wgmma``), emulated in torch on the CPU and held against the port's
oracle ``proxy_score_plain`` and the JAX XLA path (``strategy.project`` +
``strategy.score``, what XlaBackend runs).

Where the row tiles do not fill the card, the kernel splits d across the
CTAs of a cluster: CTA q projects the 64-column stages [q, q + 1) * per of
d (per = ceil(stages / split)) into an f32 partial, and the owner of a row
sums the partials of ranks 0, 1, ..., split - 1 in that order.  The
emulation does the same on bf16-valued f32 tensors (a bf16 x bf16 product
is exact in f32, so each partial is an f32 matmul), then rounds p to bf16
and forms the cosine of the rounded p against p_cached with f32 sums and
the norm product floored at eps.  ``_split`` restates the host's choice of
the split (a power of two, about one CTA an SM on a 132-SM H100, at most
8 and at most the number of stages).

Tolerances, as the kernel's on the card: p within one bf16 ulp (2^-7 of
each element) plus 1e-5, since sums in another order can round to the
neighbouring bf16 value; scores within 5e-3, which a cosine moves at most
when every element of p flips by one ulp.  Unchanged rows (p_cached equal
to the rounded p) score 1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.strategy import SPACache as JSPACache

from _torch_parity import np32
from repro_torch.kernels import proxy_score as tps

torch.set_num_threads(1)
BF16 = torch.bfloat16
ROWS = 128    # rows of a tile (two consumer warpgroups)
STAGE = 64    # columns of d a stage
SMS = 132


def _split(m, d):
    """The host's split of d for m = B * N rows (csrc/proxy_score.cu
    pick_split)."""
    tiles, stages = -(-m // ROWS), -(-d // STAGE)
    split = 1
    while (2 * split <= 8 and 2 * split <= stages
           and tiles * 2 * split <= SMS + tiles // 2):
        split *= 2
    return split


def _emulate(x, w, pc, split, eps=1e-8):
    """scores [B, N] f32 and p_now [B, N, r] bf16, as the kernel forms them
    from bf16 x, w and pc."""
    d = x.shape[-1]
    stages = -(-d // STAGE)
    per = -(-stages // split)
    xf, wf = x.float(), w.float()
    p = None
    for q in range(split):
        k0, k1 = q * per * STAGE, min(d, (q + 1) * per * STAGE)
        part = xf[..., k0:k1] @ wf[k0:k1] if k0 < k1 else \
            torch.zeros(x.shape[:-1] + w.shape[1:])
        p = part if p is None else p + part      # rank order
    p_now = p.to(BF16)
    pf, qf = p_now.float(), pc.float()
    num = (pf * qf).sum(-1)
    den = torch.sqrt((pf * pf).sum(-1) * (qf * qf).sum(-1))
    return num / torch.clamp(den, min=eps), p_now


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).to(BF16)


def test_split_choice():
    """The slice shape (B=4, N=512, d=4096) splits d eight ways over its 16
    row tiles, the hybrid's (B=2, N=16384) not at all, and d = 96 (two
    stages) at most two ways."""
    assert _split(4 * 512, 4096) == 8
    assert _split(2 * 16384, 4096) == 1
    assert _split(2 * 8192, 256) == 1
    assert _split(3 * 300, 96) == 2
    assert _split(2 * 33, 4096) == 8


@pytest.mark.parametrize("b,n,d,r", [
    (2, 33, 512, 16),      # ragged N, split 8, r below one 64-column block
    (3, 40, 96, 128),      # d = 96: a stage and a 32-column tail, split 2
    (2, 48, 448, 256),     # 7 stages over 8 ranks: the last rank empty
    (1, 300, 256, 128),    # three row tiles, split 4
])
def test_splitk_emulation_matches_references(b, n, d, r):
    rng = np.random.default_rng(b * n + d)
    x = _bf16(rng, (b, n, d))
    w = _bf16(rng, (d, r), d ** -0.5)
    pc = _bf16(rng, (b, n, r))
    for split in sorted({1, _split(b * n, d), 8}):
        s_e, p_e = _emulate(x, w, pc, split)
        s_p, p_p = tps.proxy_score_plain(x, w, pc)
        np.testing.assert_allclose(np32(p_e), np32(p_p), rtol=2 ** -7,
                                   atol=1e-5)
        np.testing.assert_allclose(np32(s_e), np32(s_p), rtol=0, atol=5e-3)
        strat = JSPACache(rank=r)
        jx, jw, jpc = (jnp.asarray(np32(t), jnp.bfloat16) for t in (x, w, pc))
        j_p = strat.project(jx, {}, jw)
        j_s = strat.score(j_p, jpc)
        np.testing.assert_allclose(np32(p_e), np32(j_p), rtol=2 ** -7,
                                   atol=1e-5)
        np.testing.assert_allclose(np32(s_e), np32(j_s), rtol=0, atol=5e-3)
        # unchanged rows tie at cosine 1
        same, _ = _emulate(x, w, p_e, split)
        assert float((same - 1).abs().max()) < 1e-5
