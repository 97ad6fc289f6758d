"""PyTorch port vs the JAX package: the paged cache.

1. The plain paged ops (what the port runs on the CPU, and the oracle its
   CUDA kernels are held to on the card) equal the JAX package's
   ``XlaBackend`` ops and its Pallas kernels in interpret mode bit for bit:
   page copies and row commits are copies.  Cases: the zero page read as
   zeros and never written, the top-k sentinel N, idx < 0, idx // page >=
   n_log, short rows whose tail maps to page 0, and every buffer type of the
   cache (f32, bf16, int8 K/V, f16 scales with and without a feature axis).
   ``proxy_score_paged``'s plain version equals the JAX XLA path to 1e-5
   (f32 sums in a different order) and the port's dense ``proxy_score`` on
   the gathered pages exactly.
2. A paged ``DecodeSession`` of the port equals the JAX paged session
   (``XlaBackend``) on the same weights and proxies: identical tokens and
   step counts, arenas within rtol/atol 1e-4, int8 codes within 1; for
   ``singular`` and ``none``, f32 and int8 caches, full-length and mixed
   ``kv_len`` rows.
3. In the port, a paged decode of full-length rows equals the dense one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.strategy import NoCache as JNoCache
from repro.core.strategy import SPACache as JSPACache
from repro.dlm.session import DecodeSession as JSession
from repro.kernels import scatter_update as jsc
from repro.kernels.backend import XLA_BACKEND
from repro.serving.pool import PagePool as JPool

from _torch_parity import np32, port_cfg, port_params, port_proxies
from repro_torch.core.cache import PagedCache
from repro_torch.core.strategy import NoCache as TNoCache
from repro_torch.core.strategy import SPACache as TSPACache
from repro_torch.dlm.session import DecodeSession as TSession
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import proxy_score as tps
from repro_torch.kernels import scatter_update as tsc
from repro_torch.serving.pool import PagePool as TPool
from repro_torch.serving.pool import cache_signature

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
N_LOG = CANVAS // PAGE
# row 0 owns two pages (its tail maps to the zero page), row 1 all four
PT = np.asarray([[1, 2, 0, 0], [3, 4, 5, 6]], np.int32)
# sorted rows, the sentinel CANVAS, idx < 0, logical pages >= n_log and
# (row 0) rows on the zero page
IDX = np.asarray([[-1, 0, 1, 5, 9, 15, CANVAS, CANVAS + 7],
                  [-5, 2, 4, 6, 7, 12, 15, CANVAS]], np.int32)
# (feature shape, dtype) of every buffer kind of the cache
BUFFERS = {"f32": ((8,), "float32"), "bf16": ((8,), "bfloat16"),
           "int8_kv": ((2, 8), "int8"), "f16_kv_scale": ((2,), "float16"),
           "f16_h_scale": ((), "float16")}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "float16": torch.float16}


def _rand(rng, shape, dtype):
    """Random jax array of ``dtype`` and the same values as a torch
    tensor."""
    if dtype == "int8":
        j = jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
        return j, torch.from_numpy(np.asarray(j).copy())
    j = jnp.asarray(rng.standard_normal(shape), dtype)
    return j, torch.from_numpy(np32(j)).to(_TORCH[dtype])


def _same(t, j):
    assert t.dtype == _TORCH[jnp.dtype(j.dtype).name]
    np.testing.assert_array_equal(np32(t), np32(j))


def _arena(rng, feat, dtype, layers=3, pages=9):
    j, t = _rand(rng, (layers, pages, PAGE) + feat, dtype)
    return j.at[:, 0].set(0), t.index_fill(1, torch.tensor([0]), 0)


@pytest.mark.parametrize("buf", sorted(BUFFERS))
def test_gather_scatter_pages_match_jax(buf):
    feat, dtype = BUFFERS[buf]
    rng = np.random.default_rng(0)
    j_arena, t_arena = _arena(rng, feat, dtype)
    pt_j, pt_t = jnp.asarray(PT), torch.from_numpy(PT)
    t_dense = tsc.gather_pages_plain(t_arena, pt_t)
    _same(t_dense, XLA_BACKEND.gather_pages(j_arena, pt_j))
    _same(t_dense, jsc.gather_pages(j_arena, pt_j, interpret=True))
    assert not t_dense[:, 0, 2 * PAGE:].any()     # zero page reads zero
    j_new, t_new = _rand(rng, (3, 2, CANVAS) + feat, dtype)
    want = XLA_BACKEND.scatter_pages(j_arena, pt_j, j_new)
    np.testing.assert_array_equal(
        np32(jsc.scatter_pages(j_arena, pt_j, j_new, interpret=True)),
        np32(want))
    got = tsc.scatter_pages_plain(t_arena, pt_t, t_new)
    assert got is t_arena                         # in place
    _same(got, want)
    assert not got[:, 0].any()                    # page 0 never written


@pytest.mark.parametrize("buf", sorted(BUFFERS))
def test_scatter_rows_paged_matches_jax(buf):
    feat, dtype = BUFFERS[buf]
    rng = np.random.default_rng(1)
    j_arena, t_arena = _arena(rng, feat, dtype, layers=2)
    j_rows, t_rows = _rand(rng, IDX.shape + feat, dtype)
    pt_j, idx_j = jnp.asarray(PT), jnp.asarray(IDX)
    # one layer of a stacked arena, written through the slice
    want = XLA_BACKEND.scatter_rows_paged(j_arena[1], pt_j, idx_j, j_rows)
    np.testing.assert_array_equal(
        np32(jsc.scatter_rows_paged(j_arena[1], pt_j, idx_j, j_rows,
                                    interpret=True)), np32(want))
    before = t_arena.clone()
    tsc.scatter_rows_paged_plain(t_arena[1], torch.from_numpy(PT),
                                 torch.from_numpy(IDX), t_rows)
    _same(t_arena[1], want)
    assert torch.equal(t_arena[0], before[0])     # other layer untouched
    assert not t_arena[1, 0].any()                # zero page intact
    # exactly the in-range rows on real pages changed
    written = (~torch.eq(t_arena[1], before[1]).reshape(9, PAGE, -1)
               .all(-1)).sum()
    assert int(written) == 3 + 6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proxy_score_paged_plain_matches_jax(dtype):
    rng = np.random.default_rng(2)
    d, r = 32, 8
    jx, tx = _rand(rng, (2, CANVAS, d), dtype)
    jw, tw = _rand(rng, (d, r), dtype)
    j_arena, t_arena = _arena(rng, (r,), dtype, layers=1)
    pt = torch.from_numpy(PT)
    s, p = tps.proxy_score_paged_plain(tx, tw, t_arena[0], pt)
    # the port's own dense path on the gathered pages: exactly
    s_d, p_d = tps.proxy_score_plain(
        tx, tw, tsc.gather_pages_plain(t_arena, pt)[0])
    assert torch.equal(s, s_d) and torch.equal(p, p_d)
    # the JAX XLA path (XlaBackend.identifier_scores with a page table)
    strat = JSPACache(rank=r)
    js, jp = XLA_BACKEND.identifier_scores(strat, {}, jw, jx, j_arena[0],
                                           page_table=jnp.asarray(PT))
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(np32(p), np32(jp), rtol=tol, atol=tol)
    np.testing.assert_allclose(np32(s), np32(js), rtol=0,
                               atol=1e-5 if dtype == "float32" else 5e-3)


def test_paged_identification_dispatch():
    """CudaBackend's paged identification: a plain matrix takes
    proxy_score_paged, another projection is scored dense on the gathered
    pages, an identity projection takes cosine_drift_paged (equal to its
    plain version)."""
    rng = np.random.default_rng(3)
    x = torch.randn(2, CANVAS, 16, generator=torch.Generator().manual_seed(0))
    w = torch.randn(16, 8, generator=torch.Generator().manual_seed(1))
    arena = _arena(rng, (8,), "float32", layers=1)[1][0]
    pt = torch.from_numpy(PT)
    cuda, plain = tbackend.CUDA_BACKEND, tbackend.TORCH_BACKEND
    strat = TSPACache(rank=8)
    want = tps.proxy_score_paged_plain(x, w, arena, pt)
    for backend in (cuda, plain):
        got = backend.identifier_scores(strat, {}, w, x, arena,
                                        page_table=pt)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    @dataclasses.dataclass(frozen=True)
    class Unfused(TSPACache):       # a projection that is no plain matrix
        def projection_matrix(self, bp, proxy_mat=None):
            return None

    got = cuda.identifier_scores(Unfused(rank=8), {}, w, x, arena,
                                 page_table=pt)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)

    @dataclasses.dataclass(frozen=True)
    class Identity(Unfused):
        def project(self, h, bp, proxy_mat=None):
            return h

    xi = x[..., :8]
    s_i, p_i = cuda.identifier_scores(Identity(rank=8), {}, w, xi, arena,
                                      page_table=pt)
    assert p_i is xi
    assert torch.equal(s_i, tps.cosine_drift_paged_plain(xi, arena, pt))


def test_pool_allocator_matches_jax(tiny_cfg):
    """The same alloc / retain / release / free sequence on both pools:
    the same pages, accounting, fragmentation, refcounts and arena shapes
    (page 0 never handed out)."""
    strat = dict(rank=16)
    jp = JPool(tiny_cfg, n_pages=9, page_size=PAGE,
               strategy=JSPACache(**strat))
    tp = TPool(port_cfg(tiny_cfg), n_pages=9, page_size=PAGE,
               strategy=TSPACache(**strat), device="cpu")

    def both(fn):
        out = [fn(jp), fn(tp)]
        assert out[0] == out[1]
        return out[1]

    a = both(lambda p: p.alloc(3))
    b = both(lambda p: p.alloc(4))
    assert 0 not in a + b and both(lambda p: p.alloc(2)) is None
    both(lambda p: p.retain(a[:1]))
    both(lambda p: p.release(a))           # a[0] keeps one hold
    both(lambda p: p.note_step())
    both(lambda p: p.free(b[1:3]))
    for fn in (lambda p: (p.available, p.used, p.capacity, p.peak_used,
                          p.utilization, p.steady_utilization),
               lambda p: p.refcounts, lambda p: p.refcount(a[0]),
               lambda p: p.free_fragmentation(),
               lambda p: p.page_table_row(b[:1], CANVAS),
               lambda p: p.pages_for(7)):
        both(fn)
    j_ar = jp.arenas_for(JSPACache(**strat))
    t_ar = tp.arenas_for(TSPACache(**strat))
    assert tp.arenas_for(TSPACache(rank=16, rho_peak=0.9)) is t_ar
    assert tp.arenas_for(TNoCache()) == {}
    assert {k: {n: tuple(a.shape) for n, a in v.items()}
            for k, v in t_ar.items()} == \
        {k: {n: tuple(a.shape) for n, a in v.items()}
         for k, v in j_ar.items()}
    assert tp.debug_state() == jp.debug_state()
    tp.reset_telemetry()
    assert tp.steady_utilization == 0.0 and tp.peak_used == tp.used
    sig = cache_signature(tp.cfg, TSPACache(**strat))
    assert tp.peek_arenas(sig) is t_ar
    tp.put_arenas(sig, {})
    assert tp.peek_arenas(sig) == {}


# ---------------------------------------------------------------------------
# Paged sessions
# ---------------------------------------------------------------------------

def _rows(cfg, prompts, gens):
    b = len(prompts)
    tokens = np.full((b, CANVAS), cfg.mask_id, np.int32)
    active = np.zeros((b, CANVAS), bool)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        tokens[i, :len(p)] = p
        active[i, len(p):len(p) + g] = True
    return tokens, active


def _paged_run(Pool, Session, cfg, params, strat, tokens, active, kv_lens,
               **kw):
    """A paged session over a pool: each row owns the pages covering its
    kv_len (tail = zero page).  Returns the session after ``run``."""
    b = len(kv_lens)
    pool = Pool(cfg, n_pages=1 + b * N_LOG, page_size=PAGE, strategy=strat,
                **({"device": "cpu"} if Pool is TPool else {}))
    pt = np.zeros((b, N_LOG), np.int32)
    for i, kv in enumerate(kv_lens):
        pt[i] = pool.page_table_row(pool.alloc(kv // PAGE), CANVAS)
    sess = Session(params, cfg, strategy=strat, **kw)
    sess.attach(tokens, active=active, kv_len=np.asarray(kv_lens, np.int32),
                arenas=pool.arenas_for(strat) or None, page_table=pt)
    sess.run()
    return sess


CASES = {  # name: (strategy pair, cache dtype, prompt lens, gen lens, kv_len)
    "singular_f32_full": ("singular", "float32", (8, 8), (8, 8), (16, 16)),
    "singular_f32_mixed": ("singular", "float32", (4, 8), (4, 8), (8, 16)),
    "singular_int8_mixed": ("singular", "int8", (4, 6), (4, 6), (8, 12)),
    "none_f32_mixed": ("none", "float32", (4, 8), (4, 4), (8, 12)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_paged_session_matches_jax(tiny_cfg, tiny_params, case):
    ident, cache_dtype, p_lens, gens, kv_lens = CASES[case]
    cfg = dataclasses.replace(tiny_cfg, cache_dtype=cache_dtype)
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    jstrat, tstrat = ((JSPACache(**spec), TSPACache(**spec))
                      if ident == "singular" else (JNoCache(), TNoCache()))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).astype(np.int32)
               for n in p_lens]
    tokens, active = _rows(cfg, prompts, gens)
    js = _paged_run(JPool, JSession, cfg, tiny_params, jstrat, tokens,
                    jnp.asarray(active), kv_lens)
    tcfg = port_cfg(cfg)
    proxies = (port_proxies(js.spa_proxies, tcfg)
               if js.spa_proxies is not None else None)
    ts = _paged_run(TPool, TSession, tcfg, port_params(tiny_params, tcfg),
                    tstrat, tokens, active, kv_lens, spa_proxies=proxies,
                    device="cpu")
    np.testing.assert_array_equal(ts.state.tokens.numpy(),
                                  np.asarray(js.state.tokens))
    assert ts.steps_taken == js.steps_taken == max(gens)
    if ident == "none":
        assert ts.state.cache == {}
        return
    assert isinstance(ts.state.cache, PagedCache)
    j_arenas = jax.tree.map(np.asarray, js.state.cache.arenas)
    for kind, bufs in j_arenas.items():
        assert sorted(bufs) == sorted(ts.state.cache.arenas[kind])
        for name, a in bufs.items():
            t = ts.state.cache.arenas[kind][name]
            if a.dtype == np.int8:
                assert np.abs(a.astype(np.int32)
                              - t.numpy().astype(np.int32)).max() <= 1, name
            else:
                np.testing.assert_allclose(np32(t), a.astype(np.float32),
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=f"{kind}/{name}")
            assert not t[:, 0].any(), f"{name}: the zero page was written"


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_paged_decode_equals_dense_in_port(tiny_cfg, tiny_params, backend):
    """Full-length rows: the port's paged decode equals its dense decode,
    on both backends (CudaBackend takes the plain versions on the CPU)."""
    tcfg = port_cfg(tiny_cfg)
    params = port_params(tiny_params, tcfg)
    strat = TSPACache(rank=16, schedule="uniform", rho_peak=0.3,
                      refresh_interval=3)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, tcfg.vocab_size - 1, 8).astype(np.int32)
               for _ in range(2)]
    tokens, active = _rows(tcfg, prompts, (8, 8))
    proxies = strat.build_proxies(params, tcfg)
    dense = TSession(params, tcfg, strategy=strat, backend=backend,
                     spa_proxies=proxies, device="cpu")
    dense.attach(tokens, active=active)
    dense.run()
    paged = _paged_run(TPool, TSession, tcfg, params, strat, tokens, active,
                       (CANVAS, CANVAS), backend=backend,
                       spa_proxies=proxies, device="cpu")
    assert paged.refresh_count == dense.refresh_count > 0
    assert torch.equal(paged.state.tokens, dense.state.tokens)
