"""PyTorch port vs the JAX package: NaN quarantine.

The JAX ``tests/test_faults.py`` ``step_nan`` scenario through both engines
(canvas 32, so the budget k = 16 < N leaves poisoned rows in the cache the
step reads): the poisoned request alone is aborted, its lane-mate is
preempted and resumes byte-identical to a fault-free twin, nothing leaks.
Then, in the port alone with the plain kernels, a poisoned page that is
freed and reallocated leaks no NaN into its next owner: the survivors that
reuse the poisoned pages decode as they do in a fault-free engine.
"""
import numpy as np
import torch

from _torch_parity import (assert_fault_runs_match, fault_engines,
                           fault_outcomes)
from repro_torch.dlm import session as tsession
from repro_torch.serving import pool as tpool

torch.set_num_threads(1)
CANVAS = 32
PAGE = 4


def _engines(cfg, params, plan=None):
    return fault_engines(cfg, params, plan=plan, canvas=CANVAS,
                         pool_pages=2 * (CANVAS // PAGE) + 1,
                         prefix_cache=False, supervise=True)


def test_nan_quarantine_aborts_only_poisoned_row(tiny_cfg, tiny_params):
    prompts = [np.asarray([1, 2, 3, 4], np.int32),
               np.asarray([9, 8, 7, 6], np.int32)]
    _, clean = _engines(tiny_cfg, tiny_params)  # the port's fault-free twin
    jeng, teng = _engines(tiny_cfg, tiny_params, dict(at={"step_nan": (2,)}))
    for eng in (clean, jeng, teng):
        for p in prompts:
            eng.submit(p, gen_len=CANVAS - 4)
        eng.run()
    want = fault_outcomes(clean)
    got = assert_fault_runs_match(jeng, teng)
    assert teng.stats.requests_faulted == 1
    assert teng.stats.requests_done == 1
    assert teng.stats.nan_quarantines >= 1
    faulted = [r for r in teng.done if r.fault == "nan"]
    survivor = [r for r in teng.done if r.fault is None]
    assert len(faulted) == 1 and faulted[0].output is None
    assert len(survivor) == 1 and survivor[0].preemptions >= 1
    uid = survivor[0].uid
    assert got[uid][3] == want[uid][3]           # its fault-free twin's
    assert teng.pool.used == 0 and not teng.pool.refcounts


def test_poisoned_pages_reused_leak_nothing(tiny_cfg, tiny_params,
                                            monkeypatch):
    """Two full-canvas requests fill the pool; the NaN fault poisons one
    of them, which is quarantined and frees its pages; its lane-mate and
    two queued shorter requests are admitted onto pages that include the
    poisoned ones.  Every survivor's output equals a fault-free engine's,
    and the poisoned pages really were handed out again."""
    poisoned, reused = set(), set()
    poison = tsession.DecodeSession.poison_cache_pages
    alloc = tpool.PagePool.alloc

    def record_poison(self, pages):
        poisoned.update(pages)
        return poison(self, pages)

    def record_alloc(self, n):
        pages = alloc(self, n)
        if pages and poisoned:
            reused.update(set(pages) & poisoned)
        return pages

    monkeypatch.setattr(tsession.DecodeSession, "poison_cache_pages",
                        record_poison)
    monkeypatch.setattr(tpool.PagePool, "alloc", record_alloc)
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, tiny_cfg.vocab_size - 1, 4).astype(np.int32),
             CANVAS - 4) for _ in range(2)]
    reqs += [(rng.integers(0, tiny_cfg.vocab_size - 1, 6).astype(np.int32),
              g) for g in (10, 6)]
    outs = []
    for plan in (None, dict(at={"step_nan": (3,)})):
        _, teng = _engines(tiny_cfg, tiny_params, plan)
        for p, g in reqs:
            teng.submit(p, gen_len=g)
        teng.run()
        outs.append(fault_outcomes(teng))
        assert teng.pool.used == 0
    clean, chaos = outs
    assert teng.stats.nan_quarantines == 1 and teng.stats.requests_done == 3
    assert poisoned and reused, (poisoned, reused)
    for uid, (fault, _, _, out) in chaos.items():
        if fault is None:
            assert out == clean[uid][3], uid
            assert np.isin(np.frombuffer(out, np.int32),
                           np.arange(tiny_cfg.vocab_size)).all()
