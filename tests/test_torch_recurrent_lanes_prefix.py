"""Recurrent stacks through the ServingEngine, part 3 of 4: the reduced
RG-LRU hybrid's paged lanes with the prefix index on, against the JAX
engine's (see ``test_torch_recurrent_lanes.py``)."""
import torch

from _torch_parity import recurrent_lanes_match
from repro_torch.dlm.decoding import partial_prefill_supported

torch.set_num_threads(1)


def test_hybrid_prefix_lanes_match_jax():
    """The repeat of the published prompt is a full hit on both engines
    (the local layer's pages are shared); a hybrid takes no partial hit
    (``partial_prefill_supported`` is False, as in the JAX package)."""
    jeng, teng = recurrent_lanes_match("hybrid", "prefix")
    assert teng.stats.prefix_full_hits == teng.stats.prefix_hits >= 1
    assert teng.stats.prefix_published > 0
    assert not partial_prefill_supported(teng.cfg)
