"""Recurrent stacks through the ServingEngine, part 4 of 4: the reduced
Mamba2 (2 SSD layers) in dense lanes, paged lanes and paged lanes with the
prefix index on, each against the JAX engine in the same mode (see
``test_torch_recurrent_lanes.py``)."""
import pytest
import torch

from _torch_parity import recurrent_lanes_match

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", ["dense", "paged", "prefix"])
def test_ssd_lanes_match_jax(mode):
    """Mamba2 decodes under ``NoCache``: its requests hold no pages and its
    paged lanes have no arenas, so the prefix index never hits, as in the
    JAX engine."""
    jeng, teng = recurrent_lanes_match("ssd", mode)
    assert teng.strategy.name == "none"
    assert teng.stats.prefix_hits == teng.stats.prefix_published == 0
    if mode != "dense":
        assert teng.pool.arenas_for(teng.strategy) == {}
        assert teng.stats.peak_pool_util == 0
