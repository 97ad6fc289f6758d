"""Recurrent stacks through the ServingEngine, part 2 of 4: the reduced
RG-LRU hybrid's paged lanes against the JAX engine's (see
``test_torch_recurrent_lanes.py``)."""
import numpy as np
import torch

from _torch_parity import recurrent_lanes_match
from repro_torch.serving.engine import ServingEngine

torch.set_num_threads(1)


def test_hybrid_paged_lanes_match_jax():
    """Paged lanes equal the JAX engine's paged lanes.  They decode other
    tokens than dense lanes, in the JAX engine as in the port: a reference
    behaviour reproduced, not fixed (the bidirectional recurrence runs
    over the whole canvas, past a short row's ``kv_len``, where a paged
    row's cache tail is the zero page)."""
    jeng, teng = recurrent_lanes_match("hybrid", "paged")
    assert set(teng.pool.arenas_for(teng.strategy)) == {"local"}
    dense = ServingEngine(teng.cfg, teng.params, strategy=teng.strategy,
                          max_batch=2, canvas_len=teng.canvas_len,
                          device="cpu")
    dense._proxies = teng._proxies
    paged = {r.uid: r.output for r in teng.done}
    dense.submit(teng.done[0].prompt, gen_len=8)
    dense.run()
    assert not np.array_equal(dense.done[0].output,
                              paged[teng.done[0].uid])
