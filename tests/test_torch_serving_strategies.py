"""PyTorch port vs the JAX package: ServingEngine lanes of the caching
baselines and the incremental identifier.

The port's engine and the JAX engine serve the same mixed-length requests
(continuous batching, 2 slots, so rows are swapped mid-decode) with the
same weights, on dense lanes and on paged lanes (pages of 4 rows; a short
row's tail maps to the zero page, so the paged identification kernels
read it).  The bar of ``tests/test_torch_serving.py``: identical outputs
for every uid, equal ``steps``, ``swaps``, ``preemptions``,
``requests_done`` and ``admission_stalls``, and a drained pool.  The
canvas is 32 rows so that the budget's k (rounded up to 16) stays below
N and identification decides which rows refresh.
"""
import numpy as np
import pytest
import torch

from repro.core import strategy as jstrategy

from _torch_parity import assert_engines_match, serve_both
from repro_torch.core import strategy as tstrategy

torch.set_num_threads(1)
PAGE, CANVAS = 4, 32
# name -> (class name, constructor kwargs), the same in both packages
STRATEGIES = {
    "value": ("ValueProxyCache", dict(rho=0.3)),
    "attn_in": ("ValueProxyCache", dict(projection="attn_in", rho=0.3)),
    "window": ("WindowCache", dict(locality_window=4, rho=0.3)),
    "attn_out": ("AttnOutCache", dict(rho=0.3)),
    "spa_incremental": ("SPACache", dict(rank=16, schedule="uniform",
                                         rho_peak=0.3,
                                         incremental_ident=True)),
}
# (prompt length, gen_len): mixed, so paged rows own different page counts
SHAPES = ((8, 24), (12, 12), (8, 8), (10, 22))


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_engine_lane_matches_jax(tiny_cfg, tiny_params, name, paged):
    cls, kw = STRATEGIES[name]
    rng = np.random.default_rng(4)
    reqs = [(rng.integers(0, tiny_cfg.vocab_size - 1, p).astype(np.int32),
             g, 0) for p, g in SHAPES]
    jeng, teng = serve_both(
        tiny_cfg, tiny_params, reqs,
        strategies=(getattr(jstrategy, cls)(**kw),
                    getattr(tstrategy, cls)(**kw)),
        max_batch=2, canvas_len=CANVAS, page_size=PAGE,
        pool_pages=1 + 2 * (CANVAS // PAGE) if paged else 0)
    assert_engines_match(jeng, teng)
    assert teng.stats.requests_done == len(SHAPES)
    assert teng.stats.swaps > 0
