"""PyTorch port vs the JAX package: the reduced MoE configs served.

Reduced Mixtral-8x22B (SWA, f32 cache) and Qwen3-MoE (int8 cache), 2
layers of 4 experts top-2, through the JAX ``ServingEngine`` and the
port's, dense and paged lanes (pages of 4, the prefix index on when
paged): the same outputs and engine counters.  In paged lanes the rows
past a request's ``kv_len`` still route and take expert capacity, as in
JAX, so outputs only match if the port routes them too.
"""
import numpy as np
import pytest
import torch

from _torch_parity import (MOE_CFGS, assert_engines_match, dense_strategies,
                           engine_pair, moe_model)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def moe_models():
    return {name: moe_model(name, 8) for name in MOE_CFGS}


@pytest.mark.parametrize("name", sorted(MOE_CFGS))
@pytest.mark.parametrize("paged", [False, True])
def test_moe_engine_matches_jax(moe_models, name, paged):
    """Four requests (the last repeats the first) through the JAX engine
    and the port's, dense or paged lanes (pages of 4, prefix index on
    when paged; rows past kv_len route too): identical outputs and
    counters."""
    cfg, params, _ = moe_models[name]
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg.vocab_size - 1, n).astype(np.int32)
               for n in (6, 9, 5)]
    prompts.append(prompts[0])
    kw = dict(max_batch=2, canvas_len=24)
    if paged:
        kw.update(pool_pages=14, page_size=4, prefix_cache=True)
    jeng, teng = engine_pair(cfg, params, dense_strategies(cfg, "singular"),
                             **kw)
    for eng in (jeng, teng):
        for p in prompts:
            eng.submit(p, gen_len=6)
        eng.run()
    outs = assert_engines_match(jeng, teng)
    assert len(outs) == 4
    if paged:       # a full prefix hit decodes as its publisher did
        assert teng.stats.prefix_full_hits >= 1
        np.testing.assert_array_equal(outs[3], outs[0])
