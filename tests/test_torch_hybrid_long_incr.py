"""PyTorch port vs the JAX package: the reduced RG-LRU hybrid at a long
canvas, the incremental identifier.

As ``test_torch_hybrid_long.py`` (N = 12288, B = 2, two steps, layer 2
stratified on the dense grid, layer 5 banded), with
``SPACache(incremental_ident=True)``: after each recurrent block the next
attention layer identifies in full, as the JAX package does, so the
tokens and caches agree.
"""
import torch

from _torch_parity import long_hybrid_parity

torch.set_num_threads(1)


def test_long_hybrid_incremental_matches_jax():
    log = long_hybrid_parity("incremental")
    assert log[2:] == [(639, 16384, False, True),
                       (3072, 8192, True, True)] * 2
