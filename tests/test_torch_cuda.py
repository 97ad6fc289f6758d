"""Each CUDA kernel of the port against its plain PyTorch version, on the
card.  Marked ``cuda``: without a card the test skips.  The file imports
neither jax nor the JAX package, and needs no fixture of
``tests/conftest.py`` (which imports jax), so it also runs where only
PyTorch is installed:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

Tolerances: f32 within 1e-5 (FMA order only, TF32 off); row copies
bit-exact.  bf16 outputs may flip by one bf16 ulp, since the kernel and
the plain version sum in different orders before rounding:
- ``p_now`` and normed rows: 2^-7 of each element (one ulp), plus 1e-5
  for f32 sum-order error on values that cancel to near 0;
- scores: 5e-3, as a cosine moves by at most 2^-8 when every element of
  ``p`` flips by one ulp;
- attention: 2^-7 of the largest output (one ulp of it), well below the
  ~1/25 of a value that one wrongly masked key in the 25-key window moves;
  bf16 K/V of any head_dim that is a multiple of 8 (40, 80, 120 padded with
  zero columns) and GQA groups 1-16 keep that bound.

The paged kernels are copies and must match their plain versions exactly,
drop rules included; ``proxy_score_paged`` shares its kernel body with
``proxy_score`` and must equal it bit for bit on the gathered pages, and
so must ``cosine_drift_paged`` with ``cosine_drift``.  ``cosine_drift``
sums in f32 like its plain version, in another order: 1e-5 absolute for
every pairing of f32 and bf16 operands (the inputs are the same values).
The wide-rank ``proxy_score`` (r > 256: projection kernel, then
``cosine_drift``) keeps ``proxy_score``'s tolerances; the bf16 body gives
the same bits on every call.  The banded
attention grid keeps the attention tolerances and equals the dense grid
bit for bit where its band covers the window; ``rglru_scan`` agrees with
the sequential loop within 1e-5 in f32 (its chunk carries reassociate)
and one bf16 ulp of each element in bf16, the same bits on every call.  ``ssd_chunk_scan`` sums its
f32 products in another order than the plain einsums: f32 within 1e-4 of
the largest output, bf16 within two ulps of the largest output.
"""
import math

import pytest
import torch

from repro_torch.kernels import proxy_score as tps
from repro_torch.kernels import rglru_scan as trs
from repro_torch.kernels import scatter_update as tsc
from repro_torch.kernels import sparse_attention as tsa
from repro_torch.kernels import ssd_chunk as tssd


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dtype):
    """Each kernel against its plain version, both dtypes."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False   # exact f32 plain path
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def rn(*s):
        return torch.randn(s, generator=g, device=dev).to(dtype)

    f32 = dtype == torch.float32
    elem = dict(rtol=1e-5, atol=1e-5) if f32 else dict(rtol=2 ** -7,
                                                       atol=1e-5)
    x, w, pc = rn(2, 70, 256), rn(256, 32) * 0.1, rn(2, 70, 32)
    (s_k, p_k), (s_p, p_p) = (tps.proxy_score(x, w, pc),
                              tps.proxy_score_plain(x, w, pc))
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-5 if f32 else 5e-3)
    torch.testing.assert_close(p_k.float(), p_p.float(), **elem)
    idx = torch.tensor([[3, -1, 69, 200, 5]] * 2, dtype=torch.int32,
                       device=dev)
    (r_k, n_k), (r_p, n_p) = (tps.gather_norm(x, idx, w[:, 0], 1e-6),
                              tps.gather_norm_plain(x, idx, w[:, 0], 1e-6))
    assert torch.equal(r_k, r_p)
    torch.testing.assert_close(n_k.float(), n_p.float(), **elem)
    q, kv = rn(2, 10, 4, 32), rn(2, 70, 2, 32)
    pos = torch.randint(0, 70, (2, 10), generator=g, device=dev)
    kvl = torch.tensor([70, 33], device=dev)
    a_k = tsa.sparse_attention(q, kv, kv, pos, window=12, soft_cap=20.0,
                               kv_len=kvl).float()
    a_p = tsa.sparse_attention_plain(q, kv, kv, pos, window=12,
                                     soft_cap=20.0, kv_len=kvl).float()
    torch.testing.assert_close(
        a_k, a_p, rtol=0,
        atol=1e-5 if f32 else 2 ** -7 * float(a_p.abs().max()))
    bufs = [rn(2, 70, 2, 32), rn(2, 70, 32)]
    rows = [rn(2, 5, 2, 32), rn(2, 5, 32)]
    got, want = [t.clone() for t in bufs], [t.clone() for t in bufs]
    tsc.scatter_update_multi(got, idx, rows)
    tsc.scatter_update_multi_plain(want, idx, rows)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_attention_refuses_untiled_bf16():
    """bf16 K/V take any head_dim that is a multiple of 8 up to 256 (zero
    columns pad it to the kernel's width): 40, 80 and 120 match the plain
    version.  A head_dim of 36 or 264, or scales on bf16 K/V, raise
    instead of taking a slower path."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    bf16 = torch.bfloat16
    pos = torch.randint(0, 90, (2, 20), generator=g, device=dev)
    kvl = torch.tensor([90, 61], device=dev)
    for hd in (40, 80, 120):
        q = torch.randn(2, 20, 8, hd, generator=g, device=dev).to(bf16)
        k = torch.randn(2, 90, 2, hd, generator=g, device=dev).to(bf16)
        v = torch.randn(2, 90, 2, hd, generator=g, device=dev).to(bf16)
        kw = dict(window=30, soft_cap=20.0, kv_len=kvl)
        got = tsa.sparse_attention(q, k, v, pos, **kw).float()
        want = tsa.sparse_attention_plain(q, k, v, pos, **kw).float()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2 ** -7 * float(want.abs().max()))
    for hd in (36, 264):
        q = torch.zeros((1, 4, 2, hd), dtype=bf16, device=dev)
        kv = torch.zeros((1, 8, 2, hd), dtype=bf16, device=dev)
        with pytest.raises(ValueError, match="head_dim"):
            tsa.sparse_attention(q, kv, kv, pos[:1, :4])
    q = torch.zeros((1, 4, 2, 32), dtype=bf16, device=dev)
    kv = torch.zeros((1, 8, 2, 32), dtype=bf16, device=dev)
    sc = torch.ones((1, 8, 2), device=dev)
    with pytest.raises(ValueError, match="scales"):
        tsa.sparse_attention(q, kv, kv, pos[:1, :4], k_scale=sc, v_scale=sc)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 2, 4, 6, 7, 16])
def test_cuda_bf16_attention_gqa_groups(group):
    """A CTA's rows are (query, head) pairs of one kv head: G = H / KVH q
    heads share each staged K/V tile, and 6 and 7 do not divide a tile of
    rows.  Dense grid at head_dim 128 with a window and kv_len, kq = 16 (a
    single partial tile) and 100, against the plain version.  At G = 7 also
    the banded grid at kq = 700: the last q block's 188 queries x 7 heads
    end in a partial tile, and no tile spans two q blocks (bit for bit the
    dense grid, whose band covers the window)."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10 + group)
    bf16 = torch.bfloat16
    kvh = 2

    def close(got, want):
        torch.testing.assert_close(
            got.float(), want.float(), rtol=0,
            atol=2 ** -7 * float(want.float().abs().max()))

    k = torch.randn(2, 300, kvh, 128, generator=g, device=dev).to(bf16)
    v = torch.randn(2, 300, kvh, 128, generator=g, device=dev).to(bf16)
    kw = dict(window=40, kv_len=torch.tensor([300, 170], device=dev))
    for kq in (16, 100):
        q = torch.randn(2, kq, kvh * group, 128, generator=g,
                        device=dev).to(bf16)
        pos = torch.randint(0, 300, (2, kq), generator=g, device=dev)
        close(tsa.sparse_attention(q, k, v, pos, **kw),
              tsa.sparse_attention_plain(q, k, v, pos, **kw))
    if group != 7:
        torch.cuda.synchronize()
        return
    n, kq = 4100, 700
    q = torch.randn(2, kq, group, 128, generator=g, device=dev).to(bf16)
    k = torch.randn(2, n, 1, 128, generator=g, device=dev).to(bf16)
    v = torch.randn(2, n, 1, 128, generator=g, device=dev).to(bf16)
    pos = torch.cat([
        torch.sort(torch.randint(0, 1500, (2, 512), generator=g,
                                 device=dev)).values,
        torch.sort(torch.randint(2000, 3000, (2, kq - 512), generator=g,
                                 device=dev)).values], dim=1)
    kw = dict(window=64, kv_len=torch.tensor([n, 2600], device=dev))
    got = tsa.sparse_attention(q, k, v, pos, banded=True, q_span=1500, **kw)
    band = tsa.band_for(pos, n, 64, 1500)
    assert band is not None and band[2] == 512
    close(got, tsa.sparse_attention_plain(q, k, v, pos, band=band, **kw))
    assert torch.equal(got, tsa.sparse_attention(q, k, v, pos, **kw))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8,
                                   torch.float16])
def test_cuda_paged_copies_match_plain(dtype):
    """gather_pages, scatter_pages and scatter_rows_paged against their
    plain versions: exact, with the zero page, the sentinel N, idx < 0,
    logical pages >= n_log and short rows; int8 K/V rows and f16 scales of
    width 2 and 1 (the int8 cache's buffers) included; scatter_rows_paged
    also at 256-byte, 8 KB, 10-byte and 2-byte rows, k in {1, 16, 128,
    4096} (and 511 at B=5), on a layer slice."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    page, n_log, p = 4, 4, 9
    feats = {torch.int8: [(2, 8)], torch.float16: [(2,), ()]}.get(
        dtype, [(8,), (2, 8)])
    pt = torch.tensor([[1, 2, 0, 0], [3, 4, 5, 6]], dtype=torch.int32,
                      device=dev)
    n = n_log * page
    idx = torch.tensor([[-1, 0, 1, 5, 9, 15, n, n + 7],
                        [-5, 2, 4, 6, 7, 12, 15, n]], dtype=torch.int32,
                       device=dev)

    def rand(*shape):
        if dtype == torch.int8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int8)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for feat in feats:
        arena = rand(3, p, page, *feat)
        arena[:, 0] = 0
        assert torch.equal(tsc.gather_pages(arena, pt),
                           tsc.gather_pages_plain(arena, pt))
        dense = rand(3, 2, n, *feat)
        got, want = arena.clone(), arena.clone()
        tsc.scatter_pages(got, pt, dense)
        tsc.scatter_pages_plain(want, pt, dense)
        assert torch.equal(got, want) and not got[:, 0].any()
        rows = rand(2, idx.shape[1], *feat)
        got, want = arena.clone(), arena.clone()
        tsc.scatter_rows_paged(got[1], pt, idx, rows)   # a layer slice
        tsc.scatter_rows_paged_plain(want[1], pt, idx, rows)
        assert torch.equal(got, want) and not got[:, 0].any()
    # scatter_rows_paged at the row widths of the port's commits: 256-byte
    # (proxy r=128 bf16) and 8 KB (r=4096) rows, 10-byte int8 and 2-byte
    # f16 rows, k up to 4096, pages of 16, unsorted indices with every drop
    # rule, into layer 1 of a two-layer arena; B=5, k=511 makes runs of two
    # rows that straddle batch rows
    widths = {torch.bfloat16: [(128,), (4096,)], torch.int8: [(10,)],
              torch.float16: [()]}.get(dtype, [(4,)])
    page = 16
    for feat in widths:
        for b_, k in ((2, 1), (2, 16), (2, 128), (5, 511), (2, 4096)):
            n = max(512, 2 * k)
            n_log = n // page
            pool = 1 + b_ * n_log
            table = (torch.randperm(pool - 1, generator=g, device=dev) + 1
                     ).reshape(b_, n_log).to(torch.int32)
            table[1, n_log // 2:] = 0                   # a short row
            ii = torch.stack([torch.randperm(n, generator=g, device=dev)[:k]
                              for _ in range(b_)]).to(torch.int32)
            if k > 1:
                ii[0, 0], ii[1, -1] = -1, n + 3 * page  # idx < 0, past n_log
            arena = rand(2, pool, page, *feat)
            arena[:, 0] = 0
            rows = rand(b_, k, *feat)
            got, want = arena.clone(), arena.clone()
            tsc.scatter_rows_paged(got[1], table, ii, rows)
            tsc.scatter_rows_paged_plain(want[1], table, ii, rows)
            assert torch.equal(got, want), (feat, k)
            assert not got[:, 0].any()
            del arena, got, want
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_proxy_score_paged_bitwise(dtype):
    """proxy_score_paged equals proxy_score on the gathered pages bit for
    bit, and its plain version within proxy_score's tolerances."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    page, n_log, d, r = 16, 5, 256, 32
    x = torch.randn(2, n_log * page, d, generator=g, device=dev).to(dtype)
    w = (torch.randn(d, r, generator=g, device=dev) * 0.1).to(dtype)
    arena = torch.randn(11, page, r, generator=g, device=dev).to(dtype)
    arena[0] = 0
    pt = torch.tensor([[1, 2, 3, 0, 0], [4, 5, 6, 7, 10]],
                      dtype=torch.int32, device=dev)
    s_k, p_k = tps.proxy_score_paged(x, w, arena, pt)
    dense = tsc.gather_pages(arena[None], pt)[0]
    s_d, p_d = tps.proxy_score(x, w, dense)
    assert torch.equal(s_k, s_d) and torch.equal(p_k, p_d)
    s_p, p_p = tps.proxy_score_paged_plain(x, w, arena, pt)
    f32 = dtype == torch.float32
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-5 if f32 else 5e-3)
    torch.testing.assert_close(p_k.float(), p_p.float(),
                               rtol=1e-5 if f32 else 2 ** -7, atol=1e-5)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("r", [8, 64, 96, 128, 4096])
def test_cuda_cosine_drift_matches_plain(r):
    """cosine_drift for every dtype pairing within 1e-5 of its plain
    version (ragged N, an all-zero row, unchanged rows scoring 1), two
    calls the same bits, and cosine_drift_paged bitwise equal to it on the
    gathered pages (zero page, short rows); again with enough rows that a
    lane group scores several."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(r)
    page, n_log = 16, 5
    n = page * n_log
    x32 = torch.randn(3, n, r, generator=g, device=dev)
    pc32 = torch.randn(3, n, r, generator=g, device=dev)
    pc32[:, :4] = x32[:, :4]                   # unchanged rows score 1
    x32[1, 9] = 0                              # the eps floor: scores 0
    pt = torch.tensor([[1, 2, 3, 0, 0], [4, 5, 6, 7, 10], [9, 8, 0, 0, 0]],
                      dtype=torch.int32, device=dev)
    for xd in (torch.float32, torch.bfloat16):
        for cd in (torch.float32, torch.bfloat16):
            x, pc = x32.to(xd), pc32.to(cd)
            pc[:, :4] = x[:, :4].to(cd)
            for m in (n, n - 3):               # full and ragged N
                got = tps.cosine_drift(x[:, :m], pc[:, :m])
                torch.testing.assert_close(
                    got, tps.cosine_drift_plain(x[:, :m], pc[:, :m]),
                    rtol=0, atol=1e-5)
                assert torch.equal(got, tps.cosine_drift(x[:, :m],
                                                         pc[:, :m]))
            if xd == cd:
                assert float((got[:, :4] - 1).abs().max()) < 1e-5
            assert float(got[1, 9]) == 0.0
            arena = torch.randn(11, page, r, generator=g,
                                device=dev).to(cd)
            arena[0] = 0
            s_k = tps.cosine_drift_paged(x, arena, pt)
            s_d = tps.cosine_drift(x, tsc.gather_pages(arena[None], pt)[0])
            assert torch.equal(s_k, s_d), (xd, cd)
            assert torch.equal(s_k, tps.cosine_drift_paged(x, arena, pt))
            torch.testing.assert_close(
                s_k, tps.cosine_drift_paged_plain(x, arena, pt), rtol=0,
                atol=1e-5)
    # enough rows that each lane group scores several (rows per group 2-3),
    # crossing page boundaries in the paged instance
    n_big = {8: 36000, 4096: 1104}.get(r, 4496)
    pages = n_big // page
    xb = torch.randn(2, n_big, r, generator=g, device=dev)
    ab = torch.randn(2 * pages + 1, page, r, generator=g, device=dev)
    ab[0] = 0
    tb = (torch.randperm(2 * pages, generator=g, device=dev) + 1
          ).reshape(2, pages).to(torch.int32)
    tb[1, pages // 2:] = 0
    for xd, cd in ((torch.float32, torch.bfloat16),
                   (torch.bfloat16, torch.bfloat16)):
        x, arena = xb.to(xd), ab.to(cd)
        dense = tsc.gather_pages(arena[None], tb)[0]
        got = tps.cosine_drift(x, dense)
        torch.testing.assert_close(got, tps.cosine_drift_plain(x, dense),
                                   rtol=0, atol=1e-5)
        assert torch.equal(tps.cosine_drift_paged(x, arena, tb), got)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_wide_proxy_score_matches_plain(dtype):
    """r = 4096 > 256: proxy_score and proxy_score_paged through the
    projection kernel, within proxy_score's tolerances of the plain
    versions, and the paged result bitwise the dense one."""
    _cuda_or_skip()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    page, n_log, d, r = 16, 3, 512, 4096
    n = page * n_log
    x = torch.randn(2, n, d, generator=g, device=dev).to(dtype)
    w = (torch.randn(d, r, generator=g, device=dev) * 0.05).to(dtype)
    pc = torch.randn(2, n, r, generator=g, device=dev).to(dtype)
    f32 = dtype == torch.float32
    s_k, p_k = tps.proxy_score(x, w, pc)
    s_p, p_p = tps.proxy_score_plain(x, w, pc)
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=1e-5 if f32 else 5e-3)
    torch.testing.assert_close(p_k.float(), p_p.float(),
                               rtol=1e-5 if f32 else 2 ** -7, atol=1e-5)
    arena = torch.randn(7, page, r, generator=g, device=dev).to(dtype)
    arena[0] = 0
    pt = torch.tensor([[1, 2, 0], [4, 5, 6]], dtype=torch.int32, device=dev)
    s_pg, p_pg = tps.proxy_score_paged(x, w, arena, pt)
    s_d, p_d = tps.proxy_score(x, w, tsc.gather_pages(arena[None], pt)[0])
    assert torch.equal(s_pg, s_d) and torch.equal(p_pg, p_d)
    torch.cuda.synchronize()



@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,r,page", [
    (2, 33, 4096, 16, 11),     # ragged N, d split over 8 CTAs, r padded to 64
    (3, 300, 96, 128, 20),     # d = 96: one stage and a zero-filled tail
    (2, 300, 4096, 256, 20),   # the widest fused rank
    (2, 8192, 256, 128, 16),   # 128 row tiles: d not split
    (1, 40, 256, 272, 8),      # wide: a 16-column last tile
    (2, 48, 512, 4096, 16)])   # wide at the value identifier's rank
def test_cuda_bf16_proxy_score_wgmma_shapes(b, n, d, r, page):
    """The bf16 wgmma body at the shapes its tiling and split treat apart:
    within proxy_score's tolerances of the plain version, unchanged rows
    scoring 1, two calls bit for bit (the split's partials are summed in
    a fixed order), and proxy_score_paged bitwise proxy_score on the
    gathered pages."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(r + n)
    bf16 = torch.bfloat16
    x = torch.randn(b, n, d, generator=g, device=dev).to(bf16)
    w = (torch.randn(d, r, generator=g, device=dev) / math.sqrt(d)).to(bf16)
    pc = torch.randn(b, n, r, generator=g, device=dev).to(bf16)
    s_k, p_k = tps.proxy_score(x, w, pc)
    s_p, p_p = tps.proxy_score_plain(x, w, pc)
    torch.testing.assert_close(s_k, s_p, rtol=0, atol=5e-3)
    torch.testing.assert_close(p_k.float(), p_p.float(), rtol=2 ** -7,
                               atol=1e-5)
    s_again, p_again = tps.proxy_score(x, w, pc)
    assert torch.equal(s_k, s_again) and torch.equal(p_k, p_again)
    same, _ = tps.proxy_score(x, w, p_k)
    assert float((same - 1).abs().max()) < 1e-5
    n_log = n // page
    arena = torch.randn(1 + b * n_log, page, r, generator=g,
                        device=dev).to(bf16)
    arena[0] = 0
    pt = (torch.randperm(b * n_log, generator=g, device=dev) + 1
          ).reshape(b, n_log).to(torch.int32)
    pt[0, -1] = 0                              # a short row: the zero page
    s_pg, p_pg = tps.proxy_score_paged(x, w, arena, pt)
    s_d, p_d = tps.proxy_score(x, w, tsc.gather_pages(arena[None], pt)[0])
    assert torch.equal(s_pg, s_d) and torch.equal(p_pg, p_d)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rglru_scan_chunk_edges(dtype):
    """The one-pass scan at the lengths around its chunk of 64 steps (one
    step, one chunk less or more, many chunks) and at widths of one and
    several channel tiles (d = 8; 77, whose rows are no multiple of 16
    bytes: the plain-copy path; 512): within rglru_scan's tolerances of
    the sequential loop, one launch a call, and two calls bit for bit (the
    carries do not depend on the look-back's schedule)."""
    _cuda_or_skip()
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    for t in (1, 63, 64, 65, 1001):
        for d in (8, 77, 512):
            a = (1.0 - 0.1 * torch.rand(2, t, d, generator=g, device=dev)
                 ).to(dtype)
            x = (torch.randn(2, t, d, generator=g, device=dev) * 0.1
                 ).to(dtype)
            before = _lib.launch_counts()["rglru_scan"]
            got = trs.rglru_scan(a, x)
            assert _lib.launch_counts()["rglru_scan"] == before + 1
            torch.testing.assert_close(
                got.float(), trs.rglru_scan_plain(a, x).float(), **tol)
            assert torch.equal(got, trs.rglru_scan(a, x)), (t, d)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
def test_cuda_banded_attention_matches_plain(dtype):
    """The banded grid against the plain banded version (MQA at head_dim
    256, GQA at 64, int8 K/V with scales at 256, ragged kq and N), bit for
    bit equal to the dense grid where the band covers the window, and
    counted as ``sparse_attention_banded``."""
    _cuda_or_skip()
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    qdt = torch.float32 if dtype == torch.int8 else dtype
    for b, n, kq, h, kvh, hd in ((2, 4100, 700, 4, 1, 256),
                                 (1, 4096, 1024, 4, 2, 64)):
        q = torch.randn(b, kq, h, hd, generator=g, device=dev).to(qdt)
        if dtype == torch.int8:
            k = torch.randint(-127, 128, (b, n, kvh, hd), generator=g,
                              device=dev, dtype=torch.int8)
            v = torch.randint(-127, 128, (b, n, kvh, hd), generator=g,
                              device=dev, dtype=torch.int8)
            ks = torch.rand(b, n, kvh, generator=g, device=dev) * 0.02
            vs = torch.rand(b, n, kvh, generator=g, device=dev) * 0.02
        else:
            k = torch.randn(b, n, kvh, hd, generator=g, device=dev).to(dtype)
            v = torch.randn(b, n, kvh, hd, generator=g, device=dev).to(dtype)
            ks = vs = None
        n0 = min(512, kq)
        pos = torch.cat([
            torch.sort(torch.randint(0, 1500, (b, n0), generator=g,
                                     device=dev)).values,
            torch.sort(torch.randint(2000, 3000, (b, kq - n0), generator=g,
                                     device=dev)).values], dim=1)
        kw = dict(k_scale=ks, v_scale=vs, window=64, soft_cap=20.0,
                  kv_len=torch.tensor([n, 2600][:b], device=dev))
        before = _lib.launch_counts()
        got = tsa.sparse_attention(q, k, v, pos, banded=True, q_span=1500,
                                   **kw)
        after = _lib.launch_counts()
        assert after["sparse_attention_banded"] == \
            before["sparse_attention_banded"] + 1
        assert after["sparse_attention"] == before["sparse_attention"]
        band = tsa.band_for(pos, n, 64, 1500)
        want = tsa.sparse_attention_plain(q, k, v, pos, band=band, **kw)
        torch.testing.assert_close(
            got.float(), want.float(), rtol=0,
            atol=1e-5 if qdt == torch.float32
            else 2 ** -7 * float(want.float().abs().max()))
        assert torch.equal(got, tsa.sparse_attention(q, k, v, pos, **kw))
    # q blocks far wider than q_span: the band does not cover the window,
    # and the keys the window admits past the band are dropped, as in JAX
    pos = torch.sort(torch.randint(0, n, (b, kq), generator=g,
                                   device=dev)).values
    band = tsa.band_for(pos, n, 64, 64)
    assert band is not None
    got = tsa.sparse_attention(q, k, v, pos, banded=True, q_span=64, **kw)
    want = tsa.sparse_attention_plain(q, k, v, pos, band=band, **kw)
    torch.testing.assert_close(
        got.float(), want.float(), rtol=0,
        atol=1e-5 if qdt == torch.float32
        else 2 ** -7 * float(want.float().abs().max()))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_bf16_attention_head_dim_256():
    """The wgmma body at head_dim 256 (RecurrentGemma's heads), MQA,
    dense grid with a window, against the plain version."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    bf16 = torch.bfloat16
    q = torch.randn(2, 130, 16, 256, generator=g, device=dev).to(bf16)
    kv = torch.randn(2, 1000, 1, 256, generator=g, device=dev).to(bf16)
    pos = torch.randint(0, 1000, (2, 130), generator=g, device=dev)
    for window in (0, 100):
        got = tsa.sparse_attention(q, kv, kv, pos, window=window).float()
        want = tsa.sparse_attention_plain(q, kv, kv, pos,
                                          window=window).float()
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2 ** -7 * float(want.abs().max()))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rglru_scan_matches_plain(dtype):
    """The chunked scan against the sequential plain loop: f32 within
    1e-5 (the chunk carries reassociate), bf16 outputs within one bf16
    ulp (2^-7 of each element); ragged T and d (the scalar path), 16-byte
    vectors, and a flipped (reverse-direction) input."""
    _cuda_or_skip()
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    tol = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
           else dict(rtol=2 ** -7, atol=1e-5))
    for b, t, d in ((2, 1000, 256), (3, 333, 77), (1, 64, 8)):
        # decays in [0.9, 1): the carries between chunks of 64 matter
        a = (1.0 - 0.1 * torch.rand(b, t, d, generator=g, device=dev)
             ).to(dtype)
        x = (torch.randn(b, t, d, generator=g, device=dev) * 0.1).to(dtype)
        for flip in (False, True):
            aa = torch.flip(a, dims=(1,)) if flip else a
            xx = torch.flip(x, dims=(1,)) if flip else x
            before = _lib.launch_counts()["rglru_scan"]
            got = trs.rglru_scan(aa, xx)
            assert _lib.launch_counts()["rglru_scan"] == before + 1
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(),
                                       trs.rglru_scan_plain(aa, xx).float(),
                                       **tol)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_ssd_chunk_scan_matches_plain(dtype):
    """The SSD chunked scan against the plain chunked einsums: Mamba2-370m's
    widths (hd 64, ds 128, chunk 256) over several chunks and over 16
    chunks at T = 4096, H = 32 (the pass over the chunk states), one chunk
    shorter than 256 (T < chunk: ragged 64-row tiles), narrow and odd
    widths (36 and 20: rows no multiple of 16 bytes, copied element by
    element), H = 5 and 3 (no multiple of the kernel's pair of heads), and
    steps large enough that exp(la_i - la_j) for j > i would overflow f32
    if the kernel formed it (the output must stay finite).  Two calls on
    the same inputs return the same bits: the stages sum in a fixed order,
    with no atomics."""
    _cuda_or_skip()
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(9)
    for b, t, h, hd, ds, chunk, dt_scale in (
            (2, 768, 4, 64, 128, 256, 0.1), (1, 100, 3, 64, 128, 256, 0.1),
            (2, 96, 5, 16, 16, 16, 0.1), (1, 192, 2, 40, 72, 64, 0.1),
            (1, 256, 2, 64, 128, 256, 10.0),
            (1, 4096, 32, 64, 128, 256, 0.1),
            (2, 640, 3, 64, 128, 128, 0.1), (1, 160, 3, 36, 20, 80, 0.1)):
        cs = min(chunk, t)
        x = torch.randn(b, t, h, hd, generator=g, device=dev).to(dtype)
        bm = torch.randn(b, t, ds, generator=g, device=dev).to(dtype)
        cm = torch.randn(b, t, ds, generator=g, device=dev).to(dtype)
        dt = torch.nn.functional.softplus(
            torch.randn(b, t, h, generator=g, device=dev)) * dt_scale
        a = -torch.linspace(1.0, 16.0, h, device=dev)
        la = torch.cumsum((dt * a).reshape(b, t // cs, cs, h),
                          dim=2).reshape(b, t, h)
        before = _lib.launch_counts()["ssd_chunk_scan"]
        got = tssd.ssd_chunk_scan(x, dt, la, bm, cm, chunk)
        assert _lib.launch_counts()["ssd_chunk_scan"] == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        want = tssd.ssd_chunk_scan_plain(x, dt, la, bm, cm, chunk).float()
        assert bool(torch.isfinite(got).all())
        top = float(want.abs().max())
        lim = (1e-4 * top if dtype == torch.float32
               else 2 * 2.0 ** (math.floor(math.log2(top)) - 7))
        err = float((got.float() - want).abs().max())
        assert err <= lim, (b, t, h, hd, ds, chunk, err, lim)
        again = tssd.ssd_chunk_scan(x, dt, la, bm, cm, chunk)
        assert torch.equal(got, again), (b, t, h, hd, ds, chunk)
    with pytest.raises(ValueError, match="head_dim"):
        z = torch.zeros(1, 16, 1, 128, device=dev)
        tssd.ssd_chunk_scan(z, z[..., 0], z[..., 0], z[:, :, 0, :8],
                            z[:, :, 0, :8], 16)
    torch.cuda.synchronize()


# commits of the SPA layer step (chip_smoke.py phase 3): B, N, k and each
# buffer's trailing shape and dtype
_BF16, _F16, _I8 = torch.bfloat16, torch.float16, torch.int8
SCATTER_CASES = {
    "llada_kv_k128": (4, 512, 128, [((32, 128), _BF16), ((32, 128), _BF16)]),
    "llada_kv_k16": (4, 512, 16, [((32, 128), _BF16), ((32, 128), _BF16)]),
    "llada_h_proxy": (4, 512, 128, [((4096,), _BF16), ((128,), _BF16)]),
    "int8_kv_scales": (4, 512, 128, [((32, 128), _I8), ((32, 128), _I8),
                                     ((32,), _F16), ((32,), _F16)]),
    "int8_h_scale_proxy": (4, 512, 128, [((4096,), _I8), ((), _F16),
                                         ((128,), _BF16)]),
    "hybrid_kv_k4096": (2, 16384, 4096, [((1, 256), _BF16),
                                         ((1, 256), _BF16)]),
    "hybrid_h_proxy_k4096": (2, 16384, 4096, [((4096,), _BF16),
                                              ((128,), _BF16)]),
    # the edge: 16-byte, 64-byte, 10-byte, 4-byte and 2-byte rows in one
    # commit, with dropped indices
    "mixed_k7": (3, 64, 7, [((2, 32), _I8), ((2,), _F16), ((5,), _BF16),
                            ((), _F16), ((48,), torch.float32),
                            ((4, 8), _BF16)]),
    "mixed_k1": (3, 64, 1, [((2, 32), _I8), ((), _F16), ((5,), _BF16)]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_cuda_scatter_update_multi_shapes(case):
    """scatter_update_multi at every commit shape of the layer step, bit
    for bit its plain version (16-, 4- and 1-byte moves); unsorted
    indices, with -1, N and 2N dropped in the mixed commits; two calls the
    same bits, one launch counted a call."""
    _cuda_or_skip()
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    b, n, k, bufs = SCATTER_CASES[case]

    def rand(shape, dtype):
        if dtype == _I8:
            return torch.randint(-127, 128, shape, generator=g, device=dev,
                                 dtype=torch.int32).to(_I8)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    caches = [rand((b, n) + f, dt) for f, dt in bufs]
    rows = [rand((b, k) + f, dt) for f, dt in bufs]
    idx = torch.stack([torch.randperm(n, generator=g, device=dev)[:k]
                       for _ in range(b)]).to(torch.int32)
    if case.startswith("mixed"):
        idx[0, 0], idx[-1, -1] = -1, n
        if k > 2:
            idx[1, 1] = 2 * n
    want = [c.clone() for c in caches]
    tsc.scatter_update_multi_plain(want, idx, rows)
    for _ in range(2):
        got = [c.clone() for c in caches]
        before = _lib.launch_counts()["scatter_update_multi"]
        out = tsc.scatter_update_multi(got, idx, rows)
        assert _lib.launch_counts()["scatter_update_multi"] == before + 1
        assert all(o is t for o, t in zip(out, got))
        for t_got, t_want in zip(got, want):
            assert torch.equal(t_got, t_want), case
    torch.cuda.synchronize()


# B, N, d, k, dtype: the layer step's shapes, the edge widths (1000, 120),
# the 4-byte (4098) and 2-byte (1001) bf16 vector paths, rows that take at
# least two (4096 bf16), four (8192 bf16) and eight (8192 f32, 16384 bf16,
# 4098 f32) warps
GATHER_NORM_CASES = [
    (4, 512, 4096, 128, _BF16), (4, 512, 4096, 16, _BF16),
    (2, 16384, 4096, 4096, _BF16), (2, 16384, 4096, 720, _BF16),
    (4, 512, 4096, 128, torch.float32),
    (2, 512, 1000, 8, _BF16), (2, 512, 1000, 8, torch.float32),
    (2, 512, 120, 8, _BF16), (2, 512, 120, 8, torch.float32),
    (2, 64, 1001, 9, _BF16), (2, 64, 4098, 9, _BF16),
    (2, 64, 4098, 9, torch.float32), (2, 64, 8192, 9, _BF16),
    (2, 64, 8192, 9, torch.float32), (2, 64, 16384, 9, _BF16),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d,k,dtype", GATHER_NORM_CASES)
def test_cuda_gather_norm_shapes(b, n, d, k, dtype):
    """gather_norm against its plain version: raw rows bit for bit, normed
    rows within one bf16 ulp of each element (f32: 1e-5), indices clamped
    both ways; two calls the same bits, one launch counted a call.  A
    weight that starts 2 bytes into its storage takes the narrow path."""
    _cuda_or_skip()
    from repro_torch.kernels import _lib
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(d + k)
    h = (torch.randn((b, n, d), generator=g, device=dev) * 2).to(dtype)
    w = (torch.randn(d, generator=g, device=dev) * 0.1).to(dtype)
    idx = torch.stack([torch.randperm(n, generator=g, device=dev)[:k]
                       for _ in range(b)]).to(torch.int32)
    idx[0, 0], idx[-1, -1] = -5, n + 3
    elem = (dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32
            else dict(rtol=2 ** -7, atol=1e-5))
    rp, np_ = tps.gather_norm_plain(h, idx, w, 1e-6)
    before = _lib.launch_counts()["gather_norm"]
    rk, nk = tps.gather_norm(h, idx, w, 1e-6)
    assert _lib.launch_counts()["gather_norm"] == before + 1
    assert torch.equal(rk, rp)
    torch.testing.assert_close(nk.float(), np_.float(), **elem)
    r2, n2 = tps.gather_norm(h, idx, w, 1e-6)
    assert torch.equal(r2, rk) and torch.equal(n2, nk)
    if d == 1000:
        w_off = torch.empty(d + 1, dtype=dtype, device=dev)[1:]
        w_off.copy_(w)
        rk, nk = tps.gather_norm(h, idx, w_off, 1e-6)
        assert torch.equal(rk, rp)
        torch.testing.assert_close(nk.float(), np_.float(), **elem)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_gather_norm_refuses_wide_rows():
    """Rows wider than MAX_ROW_BYTES raise instead of launching."""
    _cuda_or_skip()
    dev = torch.device("cuda")
    d = tps.MAX_ROW_BYTES // 2 + 8
    h = torch.zeros((1, 4, d), dtype=_BF16, device=dev)
    with pytest.raises(ValueError, match="MAX_ROW_BYTES|exceed"):
        tps.gather_norm(h, torch.zeros((1, 2), dtype=torch.int32,
                                       device=dev),
                        torch.zeros(d, dtype=_BF16, device=dev))
