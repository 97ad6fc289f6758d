"""PyTorch port vs the JAX package: the reduced RG-LRU hybrid at a long
canvas, the ``attn_out`` identifier.

As ``test_torch_hybrid_long.py`` (N = 12288, B = 2, two steps), with
``attn_out``: every step runs full attention over all rows of both
attention layers for identification, on the banded grid (contiguous
queries span one q block of 512), and selects by global top-k.
"""
import torch

from _torch_parity import long_hybrid_parity

torch.set_num_threads(1)


def test_long_hybrid_attn_out_bands_its_full_attention():
    log = long_hybrid_parity("attn_out")
    assert log == [(12288, 512, True, False)] * (2 + 2 * 2)
