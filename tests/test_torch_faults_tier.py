"""PyTorch port vs the JAX package: a refused host-tier store.

The JAX ``tests/test_faults.py`` ``host_store`` scenario through both
engines (pool of 9 pages, host tier of 16 pages in f32, prefix index on):
a prompt is served cold, its entry is evicted under pool pressure and the
tier refuses the demotion write, so the entry drops; the prompt served
again decodes as it did cold.  Both engines agree on the injector log, the
counters (the tier's refused stores against JAX's tier manager), the
trace's fault instants and the pages held on both tiers.
"""
import torch

from _torch_parity import cycle_both_tiers

torch.set_num_threads(1)


def test_host_store_fault_drops_demotion(tiny_cfg, tiny_params):
    jeng, teng = cycle_both_tiers(tiny_cfg, tiny_params, "host_store")
    assert teng.pool_debug_state()["tier"]["store_faults"] == 1
    assert teng.stats.tier_store_faults == jeng.tier.store_faults == 1
    # the refused demotion dropped its entry (an 8-token prompt's entry
    # spans 2 pages), counted with the drops of a full tier, as JAX's
    assert teng.stats.prefix_dropped_pages >= 2
    assert teng.stats.tier_dropped_full == jeng.tier.dropped_full
    assert teng.host_pool.used_pages == teng.prefix.host_held_pages
