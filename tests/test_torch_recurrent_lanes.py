"""PyTorch port vs the JAX package: recurrent stacks through the
ServingEngine, dense lanes (part 1 of 4).

The JAX engine serves RecurrentGemma's RG-LRU hybrid and Mamba2's SSD stack
with no special code: recurrent layers carry no cache and are recomputed
every step.  The port serves them the same way.  Each mode is held against
the JAX engine in the same mode (``_torch_parity.recurrent_lanes_match``:
outputs, steps, swaps, preemptions, prefix hits and full hits); the modes
are not held against each other, because the JAX engine's dense and paged
lanes decode different tokens for a hybrid (the recurrence runs past a
short row's ``kv_len``; ``test_torch_recurrent_lanes_paged.py``).  Parts:
this file (the hybrid's dense lanes, and an all-RG-LRU stack, which has no
attention arenas, behind the prefix index), ``_paged`` (the hybrid's paged
lanes), ``_prefix`` (paged with the prefix index) and ``_ssd`` (Mamba2 in
all three modes).
"""
import dataclasses

import numpy as np
import torch

from _torch_parity import port_cfg, recurrent_cfg, recurrent_lanes_match
from repro_torch.models import transformer as tt
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)


def test_hybrid_dense_lanes_match_jax():
    jeng, teng = recurrent_lanes_match("hybrid", "dense")
    assert teng.cfg.layer_kinds == ("rglru", "rglru", "local")
    assert teng.pool is None


def test_rglru_stack_serves_behind_the_prefix_index():
    """A stack of RG-LRU blocks only (the reduced RecurrentGemma's default
    two layers) has an SPA strategy but no attention kind, so its pool has
    no arenas: it serves in paged lanes with the prefix index on, and
    publishes nothing (the JAX engine fails its page copy here), so every
    admission misses.  Outputs equal the port's dense lanes."""
    cfg = port_cfg(recurrent_cfg("hybrid"))
    cfg = dataclasses.replace(cfg, layer_pattern=("rglru",), n_layers=2)
    params = tt.init_params(cfg, seed=0, device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)
    outs = []
    for pool in (0, 13):
        eng = ServingEngine(cfg, params, max_batch=2, canvas_len=24,
                            pool_pages=pool, page_size=4,
                            prefix_cache=bool(pool), host_pages=4 * bool(pool),
                            device="cpu")
        for _ in range(2):
            eng.submit(prompt, gen_len=8)
            eng.run()
        outs.append([r.output for r in eng.done])
        if pool:
            assert eng.pool.arenas_for(eng.strategy) == {}
            assert (eng.stats.prefix_hits, eng.stats.prefix_published,
                    eng.stats.prefix_publish_skipped) == (0, 0, 0)
            assert eng.prefix.held_pages == 0 and eng.pool.used == 0
    np.testing.assert_array_equal(outs[1], outs[0])
