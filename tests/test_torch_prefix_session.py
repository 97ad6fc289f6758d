"""The port's shared-prefix session: attach, partial prefill and
copy-on-write (the properties of ``tests/test_prefix.py``'s session tests,
held in the port on the CPU).

1. A FULL prefix hit (every page of the row span attached from pages a
   cold session published before its first step) runs no prefill forward
   and decodes token- and step-identically to the cold decode, under
   ``run`` and ``run_compiled``, for every cached strategy; a PARTIAL hit
   runs one suffix-only attention call per layer and decodes to
   completion; the published pages never change (copy-on-write).
2. Two readers of the same shared pages: one steps (its writes go to its
   copies), the other's view is unchanged, and both decode the same
   tokens; the copy-on-write callback fires once, with the row's spec.
3. ``replace_rows(row_shared=)`` attaches a hit into a running batch.
"""
import numpy as np
import pytest
import torch

from _torch_parity import grid_recorder, port_cfg, port_params
from repro_torch.core import strategy as tstrategy
from repro_torch.dlm.session import DecodeSession, SharedPrefix
from repro_torch.kernels.backend import TORCH_BACKEND
from repro_torch.serving.pool import PagePool

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
N_LOG = CANVAS // PAGE
P_LEN = 8
IDENTS = ("singular", "singular+inc", "value", "attn_in", "window",
          "attn_out")


def _strategy(ident):
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    if ident.startswith("singular"):
        return tstrategy.SPACache(**spec,
                                  incremental_ident=ident.endswith("+inc"))
    if ident == "window":
        return tstrategy.WindowCache(locality_window=8, rho=0.3)
    if ident == "attn_out":
        return tstrategy.AttnOutCache(rho=0.5)
    return tstrategy.ValueProxyCache(projection=ident, rho=0.3)


class Setup:
    """The port's tiny model, one strategy, a pool and a canvas row."""

    def __init__(self, tiny_cfg, tiny_params, ident, seed=11, n_runs=8):
        self.cfg = port_cfg(tiny_cfg)
        self.params = port_params(tiny_params, self.cfg)
        self.strat = _strategy(ident)
        self.proxies = self.strat.build_proxies(self.params, self.cfg)
        rng = np.random.default_rng(seed)
        self.tokens = np.full((1, CANVAS), self.cfg.mask_id, np.int32)
        self.tokens[0, :P_LEN] = rng.integers(0, self.cfg.vocab_size - 1,
                                              P_LEN)
        self.active = np.zeros((1, CANVAS), bool)
        self.active[0, P_LEN:] = True
        self.pool = PagePool(self.cfg, n_pages=1 + n_runs * N_LOG,
                             page_size=PAGE, strategy=self.strat,
                             device="cpu")
        self.arenas = self.pool.arenas_for(self.strat)

    def session(self, backend=TORCH_BACKEND):
        return DecodeSession(self.params, self.cfg, strategy=self.strat,
                             spa_proxies=self.proxies, backend=backend,
                             device="cpu")

    def attach(self, pages, shared=None, backend=TORCH_BACKEND):
        sess = self.session(backend)
        pt = [self.pool.page_table_row(list(pages), CANVAS)]
        sess.attach(torch.from_numpy(self.tokens),
                    active=torch.from_numpy(self.active),
                    kv_len=torch.tensor([CANVAS]), arenas=self.arenas,
                    page_table=torch.tensor(pt), shared=shared)
        return sess

    def cold_published(self):
        """A cold session whose prefill pages are copied into index pages
        before its first step (the engine's publication)."""
        sess = self.attach(self.pool.alloc(N_LOG))
        pub = self.pool.alloc(N_LOG)
        sess.copy_cache_pages(sess.state.cache.page_table[0].tolist(), pub)
        return sess, pub

    def hit(self, pub, m, backend=TORCH_BACKEND):
        """Attach with logical pages [0, m) shared from ``pub``."""
        own = self.pool.alloc(N_LOG)
        spec = SharedPrefix(row=0, pages=tuple(pub[:m]),
                            reserve=tuple(own[:m]))
        return self.attach(list(pub[:m]) + own[m:], [spec], backend)

    def pages(self, pages):
        idx = torch.tensor(pages)
        return {kind: {nm: a[:, idx].clone() for nm, a in bufs.items()}
                for kind, bufs in self.arenas.items()}


def _assert_same(a, b):
    for kind, bufs in a.items():
        for nm, t in bufs.items():
            assert torch.equal(t, b[kind][nm]), f"{kind}/{nm}"


@pytest.mark.parametrize("ident", IDENTS)
def test_full_hit_decode_equals_cold(tiny_cfg, tiny_params, ident):
    s = Setup(tiny_cfg, tiny_params, ident)
    cold, pub = s.cold_published()
    published = s.pages(pub)
    cold_toks, cold_info = cold.run()
    cold_c = s.attach(s.pool.alloc(N_LOG))
    toks_c, info_c = cold_c.run_compiled()
    assert torch.equal(toks_c, cold_toks) and info_c == cold_info
    for m, mode in ((N_LOG, "run"), (N_LOG, "run_compiled"), (2, "run"),
                    (2, "run_compiled")):
        rec = grid_recorder()
        hit = s.hit(pub, m, backend=rec)
        attach_calls = list(rec.log)
        toks, info = getattr(hit, mode)()
        if m == N_LOG:           # full hit: a page copy, no forward
            assert attach_calls == []
            assert torch.equal(toks, cold_toks), (ident, mode)
            assert info == cold_info, (ident, mode)
        else:                    # partial hit: the suffix rows only
            assert attach_calls == [(CANVAS - m * PAGE, 0, False,
                                     True)] * s.cfg.n_layers
            assert int(hit.state.n_masked.max()) == 0
        _assert_same(s.pages(pub), published)     # copy-on-write


def test_cow_never_mutates_sibling_view(tiny_cfg, tiny_params):
    s = Setup(tiny_cfg, tiny_params, "singular", seed=3)
    _, pub = s.cold_published()
    published = s.pages(pub)
    fired = []
    sb, sc = s.hit(pub, 2), s.hit(pub, 2)
    sb.cow_callback = fired.append
    reserve = sb._shared_pending[0].reserve
    for _ in range(3):
        sb.step()             # writes land in sb's copies of the pages
    assert len(fired) == 1 and fired[0][0].reserve == reserve
    assert sb.state.cache.page_table[0, :2].tolist() == list(reserve)
    # the sibling's view is the pristine prefill (it has not stepped yet)
    assert sc.state.cache.page_table[0, :2].tolist() == pub[:2]
    _assert_same(s.pages(pub), published)
    toks_b, info_b = sb.run()
    toks_c, info_c = sc.run()
    assert torch.equal(toks_b, toks_c)
    _assert_same(s.pages(pub), published)


def test_refresh_copies_before_writing(tiny_cfg, tiny_params):
    """An explicit refresh before any step is a cache write too."""
    s = Setup(tiny_cfg, tiny_params, "singular", seed=5)
    _, pub = s.cold_published()
    published = s.pages(pub)
    hit = s.hit(pub, N_LOG)
    hit.refresh()
    assert not hit._shared_pending
    assert hit.state.cache.page_table[0].tolist() != pub
    _assert_same(s.pages(pub), published)


def test_replace_rows_attaches_a_hit(tiny_cfg, tiny_params):
    """A two-row batch swaps its row 1 for a full hit and a second batch
    row 1 for a partial hit: each decodes as the cold session does (full)
    or to completion (partial), and the published pages stay unchanged."""
    s = Setup(tiny_cfg, tiny_params, "singular", seed=7, n_runs=10)
    cold, pub = s.cold_published()
    published = s.pages(pub)
    cold_toks, _ = cold.run()
    other = np.random.default_rng(1).integers(0, s.cfg.vocab_size - 1,
                                              (1, CANVAS))
    for m in (N_LOG, 2):
        sess = s.session()
        rows = [s.pool.alloc(N_LOG), s.pool.alloc(N_LOG)]
        sess.attach(torch.from_numpy(np.concatenate([other, other])),
                    active=torch.zeros((2, CANVAS), dtype=torch.bool),
                    kv_len=torch.tensor([CANVAS, CANVAS]),
                    arenas=s.arenas, page_table=torch.tensor(
                        [s.pool.page_table_row(r, CANVAS) for r in rows]))
        own = rows[1]
        spec = SharedPrefix(row=1, pages=tuple(pub[:m]),
                            reserve=tuple(own[:m]))
        sess.replace_rows([1], s.tokens, s.active,
                          row_kv_len=np.asarray([CANVAS]),
                          row_page_table=np.asarray([s.pool.page_table_row(
                              list(pub[:m]) + own[m:], CANVAS)]),
                          row_shared=[spec])
        toks, _ = sess.run()
        if m == N_LOG:
            assert torch.equal(toks[1], cold_toks[0])
        assert int(sess.state.n_masked.max()) == 0
        _assert_same(s.pages(pub), published)
