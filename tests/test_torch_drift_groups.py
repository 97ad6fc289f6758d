"""The CUDA drift kernel's lane groups and the paged row commit's work
split, emulated in torch on the CPU (``csrc/proxy_score.cu``
``cosine_drift_kernel`` / ``drift_go``, ``csrc/paged.cu``
``rows_paged_kernel`` / ``spa_scatter_rows_paged``).

1. The drift kernel scores a row with G = min(32, r / 8) lanes (a power
   of two): lane l sums chunks l, l + G, ... of 8 elements, each element
   in order, into f32 x.p, x.x and p.p by FMAs; the group then adds the
   lanes by a butterfly (offsets G/2, ..., 1).  ``emulate_drift`` does the
   same in torch, each FMA as an f64 product and sum rounded once to f32
   (the product is exact in f64; the sum may round twice where an FMA
   rounds once, which moves a sum by at most one f32 ulp), the butterfly
   and the quotient in f32 as on the card.  At r in {8, 64, 96, 128, 4096}
   and every pairing of f32 and bf16 operands it is within 1e-5 of
   ``cosine_drift_plain`` and of the JAX Pallas ``cosine_drift`` in
   interpret mode (cosines lie in [-1, 1]; the two sum in other orders).
2. ``emulate_drift_paged`` walks the rows as the paged instance does (the
   page id loaded once for each logical page a group enters, rows read
   from the arena) and must give the dense emulation's bits on the
   gathered pages, within 1e-5 of the JAX ``cosine_drift_paged``.
3. The drift kernel's row split (rows per group, groups, grid) covers
   every row of a call exactly once, on a 132-SM card and on a small one.
4. The row commit's items (runs of up to 32 rows of the flattened [B*k]
   commit that fit a warp's moves and spread the call over the grid, or
   parts of a wider row), replayed byte by byte on a 132-SM card (a row a
   warp) and a one-SM one (runs of many rows): every byte of every kept
   (b, j) row is written exactly once, to the row the page table names,
   and a dropped row never is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import proxy_score as jps

from _torch_parity import np32
from repro_torch.kernels import proxy_score as tps
from repro_torch.kernels import scatter_update as tsc

torch.set_num_threads(1)
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = [("float32", "float32"), ("float32", "bfloat16"),
          ("bfloat16", "bfloat16"), ("bfloat16", "float32")]
RANKS = [8, 64, 96, 128, 4096]
PAGE = 4
PT = np.asarray([[1, 2, 0, 0, 0], [3, 4, 5, 6, 7], [9, 8, 0, 10, 0]],
                np.int32)

# csrc/proxy_score.cu: threads and CTAs an SM of the drift kernel;
# csrc/paged.cu: warps a CTA, moves a lane, CTAs an SM of the row commit
DRIFT_THREADS, DRIFT_CTAS_PER_SM = 256, 2
ROW_WARPS, ROW_SLOTS, ROW_CTAS_PER_SM = 4, 16, 4


def group_lanes(r: int) -> int:
    """G of ``drift_go``: the largest power of two <= min(32, r / 8)."""
    lg = 0
    while lg < 5 and (16 << lg) <= r:
        lg += 1
    return 1 << lg


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def emulate_drift(x: torch.Tensor, pc: torch.Tensor, eps: float = 1e-8
                  ) -> torch.Tensor:
    """x, pc: [M, r] (f32 or bf16).  The kernel's scores, [M] f32."""
    m, r = x.shape
    g = group_lanes(r)
    a, p = x.float(), pc.float()
    acc = {k: torch.zeros(m, g) for k in ("num", "xx", "pp")}
    lanes = torch.arange(g)
    for i in range((r // 8 + g - 1) // g):       # a lane's chunks, in order
        chunk = lanes + i * g
        live = chunk < r // 8
        for e in range(8):
            col = (chunk * 8 + e).clamp(max=r - 1)
            av, pv = a[:, col], p[:, col]
            for k, (u, v) in (("num", (av, pv)), ("xx", (av, av)),
                              ("pp", (pv, pv))):
                acc[k] = torch.where(live, _fma(u, v, acc[k]), acc[k])
    out = {}
    for k, v in acc.items():                     # the group's butterfly
        o = g // 2
        while o:
            v = v + v[:, lanes ^ o]
            o //= 2
        out[k] = v[:, 0]
    den = torch.sqrt(out["xx"] * out["pp"])
    return out["num"] / torch.clamp(den, min=eps)


def emulate_drift_paged(x: torch.Tensor, arena: torch.Tensor,
                        pt: torch.Tensor, eps: float = 1e-8
                        ) -> torch.Tensor:
    """x [B, N, r]; arena [P, page, r]; pt [B, n_log].  Rows are read
    through the page table as the paged instance reads them: the page id
    once for each logical page, then the page's rows."""
    b, n, r = x.shape
    page = arena.shape[1]
    rows, key, base = [], None, None
    for g in range(b * n):
        bb, nn = divmod(g, n)
        k = (bb, nn // page)
        if k != key:
            key, base = k, arena[int(pt[k])]
        rows.append(base[nn % page])
    pc = torch.stack(rows)
    return emulate_drift(x.reshape(b * n, r), pc, eps).reshape(b, n)


def _rand(rng, shape, dtype):
    j = jnp.asarray(rng.standard_normal(shape), dtype)
    return j, torch.from_numpy(np32(j)).to(_TORCH[dtype])


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("x_dtype,pc_dtype", DTYPES)
def test_drift_groups_match_plain_and_jax(x_dtype, pc_dtype, r):
    rng = np.random.default_rng(r + 1)
    n = 37                                        # ragged
    jx, tx = _rand(rng, (2, n, r), x_dtype)
    jpc, tpc = _rand(rng, (2, n, r), pc_dtype)
    # unchanged rows (cosine 1) and an all-zero row (the eps floor)
    jpc = jpc.at[:, :3].set(jx[:, :3].astype(pc_dtype))
    tpc[:, :3] = tx[:, :3].to(tpc.dtype)
    jx = jx.at[1, 9].set(0)
    tx[1, 9] = 0
    got = emulate_drift(tx.reshape(-1, r), tpc.reshape(-1, r)).reshape(2, n)
    plain = tps.cosine_drift_plain(tx, tpc)
    torch.testing.assert_close(got, plain, rtol=0, atol=1e-5)
    want = jps.cosine_drift(jx, jpc, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    assert float(got[1, 9]) == 0.0
    if x_dtype == pc_dtype:
        assert float((got[:, :3] - 1).abs().max()) < 1e-5


@pytest.mark.parametrize("r", RANKS)
@pytest.mark.parametrize("x_dtype,pc_dtype", DTYPES)
def test_drift_groups_paged_is_dense(x_dtype, pc_dtype, r):
    rng = np.random.default_rng(r + 2)
    n = PT.shape[1] * PAGE
    jx, tx = _rand(rng, (3, n, r), x_dtype)
    ja, ta = _rand(rng, (11, PAGE, r), pc_dtype)
    ja, ta = ja.at[0].set(0), ta.index_fill_(0, torch.tensor([0]), 0)
    pt = torch.from_numpy(PT)
    got = emulate_drift_paged(tx, ta, pt)
    dense = tsc.gather_pages_plain(ta[None], pt)[0]
    want = emulate_drift(tx.reshape(-1, r), dense.reshape(-1, r))
    assert torch.equal(got, want.reshape(3, n))
    torch.testing.assert_close(got, tps.cosine_drift_paged_plain(tx, ta, pt),
                               rtol=0, atol=1e-5)
    jw = jps.cosine_drift_paged(jx, ja, jnp.asarray(PT), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(jw), rtol=0,
                               atol=1e-5)


def drift_split(bn: int, r: int, n_sm: int):
    """``drift_go``'s split: (G, rows per group, groups, grid)."""
    g = group_lanes(r)
    gpc = DRIFT_THREADS // g
    max_groups = n_sm * DRIFT_CTAS_PER_SM * gpc
    rpg = -(-bn // max_groups)
    groups = -(-bn // rpg)
    return g, rpg, groups, -(-groups // gpc)


@pytest.mark.parametrize("bn,r", [(2048, 4096), (2048, 128), (77, 96),
                                  (32768, 128), (3 * 301, 8)])
@pytest.mark.parametrize("n_sm", [132, 4])
def test_drift_split_covers_every_row_once(bn, r, n_sm):
    g, rpg, groups, grid = drift_split(bn, r, n_sm)
    assert g & (g - 1) == 0 and 8 * g <= max(r, 8) and g <= 32
    assert grid <= n_sm * DRIFT_CTAS_PER_SM
    seen = torch.zeros(bn, dtype=torch.int64)
    for q in range(grid * (DRIFT_THREADS // g)):
        lo, hi = q * rpg, min(q * rpg + rpg, bn)
        if lo < hi:
            seen[lo:hi] += 1
    assert bool((seen == 1).all())


def rows_paged_items(row_bytes: int, n_rows: int, vec: int, n_sm: int):
    """``spa_scatter_rows_paged``'s items: (R rows a run, part bytes,
    parts a row, items)."""
    cap = 32 * ROW_SLOTS * vec
    warps = n_sm * ROW_CTAS_PER_SM * ROW_WARPS
    r_ = (min(32, cap // row_bytes, -(-n_rows // warps))
          if row_bytes <= cap else 1)
    pb = min(row_bytes, cap)
    parts = -(-row_bytes // pb)
    return r_, pb, parts, -(-n_rows // r_) * parts


def replay_rows_paged(pt, idx, row_bytes, page, vec, n_sm=132):
    """Every byte store of the kernel's warps, replayed: a dict from
    (b, j, byte) of the rows to the (page id, row in page, byte) written."""
    b, k = idx.shape
    n_log = pt.shape[1]
    n_rows = b * k
    r_, pb, parts, items = rows_paged_items(row_bytes, n_rows, vec, n_sm)
    grid = min(-(-items // ROW_WARPS), n_sm * ROW_CTAS_PER_SM)
    writes = {}
    for warp in range(grid * ROW_WARPS):
        for it in range(warp, items, grid * ROW_WARPS):
            run, part = divmod(it, parts)
            r0 = run * r_
            nr = min(r_, n_rows - r0)
            p0 = part * pb
            w = min(pb, row_bytes - p0)
            assert nr * w <= 32 * ROW_SLOTS * vec
            for lane in range(32):
                j, col = divmod(lane * vec, w)
                dj, dcol = divmod(32 * vec, w)
                for s in range(ROW_SLOTS):
                    off = (lane + 32 * s) * vec
                    if off < nr * w:
                        assert off == j * w + col
                        row = r0 + j
                        i = int(idx.view(-1)[row])
                        bb = row // k
                        if i >= 0 and i // page < n_log:
                            pid = int(pt[bb, i // page])
                            if pid > 0:
                                for e in range(vec):
                                    key = (bb, row % k, p0 + col + e)
                                    assert key not in writes, key
                                    writes[key] = (pid, i % page,
                                                   p0 + col + e)
                    j += dj
                    col += dcol
                    if col >= w:
                        col -= w
                        j += 1
    return writes


@pytest.mark.parametrize("row_bytes,vec,k", [(256, 16, 128), (256, 16, 7),
                                             (8192, 16, 5), (20480, 16, 3),
                                             (10, 1, 40), (2, 1, 33),
                                             (12, 4, 70)])
@pytest.mark.parametrize("n_sm", [132, 1])
def test_rows_paged_items_write_each_kept_row_once(row_bytes, vec, k, n_sm):
    rng = np.random.default_rng(row_bytes + k)
    page, n_log, b = 4, 64, 3
    n = page * n_log
    pt = torch.from_numpy(rng.permutation(np.arange(1, 1 + b * n_log))
                          .reshape(b, n_log).astype(np.int32))
    pt[2, n_log // 2:] = 0                              # a short row
    idx = torch.from_numpy(np.stack([rng.permutation(n)[:k]
                                     for _ in range(b)]).astype(np.int32))
    idx[0, 0], idx[1, -1] = -3, n + page                # idx < 0, past n_log
    writes = replay_rows_paged(pt, idx, row_bytes, page, vec, n_sm)
    kept = 0
    for bb in range(b):
        for j in range(k):
            i = int(idx[bb, j])
            drop = (i < 0 or i // page >= n_log
                    or int(pt[bb, i // page]) == 0)
            for byte in range(row_bytes):
                if drop:
                    assert (bb, j, byte) not in writes
                else:
                    assert writes[(bb, j, byte)] == (
                        int(pt[bb, i // page]), i % page, byte)
            kept += not drop
    assert len(writes) == kept * row_bytes and kept > 0
