"""PyTorch port vs the JAX package: a corrupted host-tier page.

The JAX ``tests/test_faults.py`` ``host_corrupt`` scenario through both
engines (``_torch_parity.cycle_both_tiers``): the demoted
entry's first host page is bit-flipped, its promotion fails the checksum
and the prompt is served by a cold prefill, identical to its cold output;
the corrupt pages are counted as JAX's tier manager counts them, and
``drop_prefix_cache`` empties both tiers.
"""
import torch

from _torch_parity import cycle_both_tiers

torch.set_num_threads(1)


def test_host_corruption_checksum_cold_fallback(tiny_cfg, tiny_params):
    jeng, teng = cycle_both_tiers(tiny_cfg, tiny_params, "host_corrupt")
    assert teng.stats.host_checksum_failures >= 1
    assert teng.stats.cold_prefill_fallbacks >= 1
    assert teng.pool_debug_state()["tier"]["checksum_failures"] >= 1
    assert teng.host_pool.used_pages == teng.prefix.host_held_pages
    for eng in (jeng, teng):
        eng.drop_prefix_cache()
        assert eng.pool.used == 0 and eng.host_pool.used_pages == 0
