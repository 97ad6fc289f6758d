"""PyTorch port vs the JAX package: the reduced RG-LRU hybrid at a long
canvas, the singular identifier.

N = 12288, B = 2, two decode steps through both ``DecodeSession.run``s
(the JAX side on its XlaBackend): identical tokens and step counts, caches
within 1e-4.  The canvas stratifies the attention layers' selection (3
strata, the fewest with which a layer can band), and the config's
schedule gives layer 2 k = 640, of which the 3 strata take 639 rows
(q_span 16384: the dense grid under stratified selection), and layer 5
k = 3072 (q_span 8192: the banded grid); the test asserts both from the
attention calls.  The prefill bands both layers (contiguous queries span
512).
"""
import torch

from _torch_parity import long_hybrid_parity

torch.set_num_threads(1)


def test_long_hybrid_singular_bands_one_layer_and_stratifies_both():
    log = long_hybrid_parity("singular")
    prefill, steps = log[:2], log[2:]
    assert prefill == [(12288, 512, True, False)] * 2
    # every step: layer 2 stratified on the dense grid, layer 5 banded
    assert steps == [(639, 16384, False, True),
                     (3072, 8192, True, True)] * 2
