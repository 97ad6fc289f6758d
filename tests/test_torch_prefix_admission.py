"""PyTorch port vs the JAX package: the paged ServingEngine with the
shared-prefix index, part 2 (admission).

Each scenario runs on the JAX engine and the port's with the same weights
and proxies (``_torch_parity.engine_pair``); outputs, engine counters,
``prefix_*`` counters and the index's held pages must be equal
(``assert_engines_match``), and each scenario's own property must hold:
admission evicts reader-less index pages before it preempts, never evicts
for a candidate it cannot admit, duplicate prompts admitted together
publish once, cancels release plans and holds, and ``submit`` rejects an
unschedulable ``gen_len``.
"""
import numpy as np
import pytest
import torch

from repro.core.strategy import SPACache as JSPACache

from _torch_parity import assert_engines_match, engine_pair
from repro_torch.core.strategy import SPACache as TSPACache

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
N_LOG = CANVAS // PAGE


def _pair(tiny_cfg, tiny_params, pool_pages, max_batch=2):
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    return engine_pair(tiny_cfg, tiny_params,
                       (JSPACache(**spec), TSPACache(**spec)),
                       max_batch=max_batch, canvas_len=CANVAS,
                       pool_pages=pool_pages, page_size=PAGE,
                       prefix_cache=True)


def _prompts(cfg, seed, n, length=8):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size - 1, length).astype(np.int32)
            for _ in range(n)]


def test_admission_evicts_index_before_preempting(tiny_cfg, tiny_params):
    """One request publishes 4 of the 8 allocatable pages; two more need
    8: the index gives its pages back, nothing is preempted."""
    first, *more = _prompts(tiny_cfg, 9, 3)
    jeng, teng = _pair(tiny_cfg, tiny_params, 9)
    for eng in (jeng, teng):
        eng.submit(first, gen_len=8)
        eng.run()
        assert eng.stats.prefix_published == N_LOG
        for p in more:
            eng.submit(p, gen_len=8)
        eng.run()
    assert_engines_match(jeng, teng)
    assert teng.stats.prefix_evicted_pages > 0
    assert teng.stats.preemptions == 0
    assert teng.stats.requests_done == 3


def test_no_eviction_for_unadmittable_candidate(tiny_cfg, tiny_params):
    """One slot, held by a priority-5 request: a later low-priority
    candidate stalls, and the index keeps its entry."""
    first, high, low = _prompts(tiny_cfg, 13, 3)
    jeng, teng = _pair(tiny_cfg, tiny_params, 10, max_batch=1)
    for eng in (jeng, teng):
        eng.submit(first, gen_len=8)
        eng.run()
        assert eng.prefix.held_pages == N_LOG
        eng.submit(high, gen_len=8, priority=5)
        s0 = eng.stats.steps

        def on_step(e):
            if e.stats.steps == s0 + 1:
                e.submit(low, gen_len=8)

        eng.run(on_step=on_step)
    assert_engines_match(jeng, teng)
    assert teng.stats.requests_done == 3
    assert teng.stats.admission_stalls > 0
    assert teng.stats.prefix_evicted_pages == 0
    assert teng.prefix.held_pages == N_LOG


def test_duplicate_prompts_publish_once(tiny_cfg, tiny_params):
    """Four copies of one prompt admitted in one batch all plan before the
    first publishes: one run is published, not four, and the rows are
    identical."""
    (p,) = _prompts(tiny_cfg, 17, 1)
    jeng, teng = _pair(tiny_cfg, tiny_params, 40, max_batch=4)
    for eng in (jeng, teng):
        for _ in range(4):
            eng.submit(p, gen_len=8)
        eng.run()
    out = assert_engines_match(jeng, teng)
    assert teng.stats.prefix_published == N_LOG
    assert teng.stats.prefix_publish_skipped == 0
    assert teng.prefix.held_pages == N_LOG
    for uid in range(1, 4):
        np.testing.assert_array_equal(out[uid], out[0])


def test_cancel_releases_plans_and_holds(tiny_cfg, tiny_params):
    """Repeats of published prompts, canceled while queued with no plan,
    while queued with the holds of the plan made as the first step ran,
    and while running (after its copy-on-write): the pool drains to the
    index's pages, as in JAX."""
    ps = _prompts(tiny_cfg, 21, 2)
    jeng, teng = _pair(tiny_cfg, tiny_params, 40)
    for eng in (jeng, teng):
        for p in ps:
            eng.submit(p, gen_len=8)
        eng.run()
        uids = [eng.submit(ps[i % 2], gen_len=8) for i in range(5)]
        s0 = eng.stats.steps

        def on_step(e):
            if e.stats.steps == s0 + 1:
                assert e.queue[0].uid == uids[2] and e.queue[0].holds
                e.cancel(uids[2])       # queued, planned
                e.cancel(uids[0])       # running, copied on write

        eng.cancel(uids[3])             # queued, no plan yet
        eng.run(on_step=on_step)
        assert eng.stats.requests_canceled == 3
    assert_engines_match(jeng, teng)
    assert teng.stats.prefix_full_hits > 0


def test_submit_rejects_unschedulable_gen_len(tiny_cfg, tiny_params):
    jeng, teng = _pair(tiny_cfg, tiny_params, 40)
    prompt = np.arange(4, dtype=np.int32)
    for eng in (jeng, teng):
        for gen in (0, CANVAS + 1, True, 2.0):
            with pytest.raises(ValueError, match="gen_len"):
                eng.submit(prompt, gen_len=gen)
        assert not eng.queue
    # a reserved row span beyond the canvas is clipped to it
    for eng in (jeng, teng):
        eng.submit(prompt, gen_len=4, row_len=4 * CANVAS)
        assert eng.queue[-1].row_len == CANVAS
