"""Phase 16(b)'s rehearsal, in the port: ``chip_smoke.py``'s own functions
at 2 reduced LLaDA layers on the CPU (the plain kernels).

16(b) serves five of the JAX serving bench's six fault-storm requests x8
in tokens and two repeats (canvas 256, pages of 16, 73 pages, host tier of
32 pages, 4 slots, ``refresh_interval=1``), clean and then under
``chip_smoke.FAULT_PLAN`` / ``FAULT_SUPERVISOR``.  The probe sequence
follows commits and admissions, not widths, so this run gives the
constants the card asserts (``FAULT_EXPECT``): the injector log, the
aborted and canceled uids and the ladder's walk up to L3 and back to L0;
besides, a NaN quarantine, a cold prefill after the corrupted page, a
watchdog recovery, an invariant check every iteration and both tiers
drained.  (Survivors against their clean twins: the smaller storms of
``test_torch_faults_storm.py`` and ``test_torch_supervisor_bench.py``.)
"""
import dataclasses
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)


def test_phase16b_rehearsal_gives_the_constants():
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.strategy import SPACache
    from repro_torch.models import transformer
    cfg = reduced(get_arch("llada-8b"), n_layers=2)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    strat = dataclasses.replace(SPACache.from_spec(cfg.spa),
                                refresh_interval=1)
    proxies = strat.build_proxies(params, cfg)
    c = cs.FAULT_FULL
    chaos = cs.fault_engine(cfg, params, strat, proxies, c,
                            plan=cs.FAULT_PLAN, sup=cs.FAULT_SUPERVISOR,
                            device="cpu")
    chaos_out, _ = cs.serve_faults(chaos, cs.fault_traffic(c), c["stream"])
    outcome = cs.fault_outcome(chaos)
    assert outcome == cs.FAULT_EXPECT
    s = chaos.stats
    assert {site for site, _ in outcome["log"]} == set(cs.FAULT_PLAN["at"])
    levels = [lvl for _, lvl in outcome["degradation_events"]]
    assert 3 in levels and levels[-1] == 0
    assert s.nan_quarantines == 1 and s.cold_prefill_fallbacks == 1
    assert s.watchdog_fires == 1 and s.disconnect_bursts == 1
    assert s.tier_store_faults == 1 and s.host_corrupt_pages >= 1
    assert s.alloc_faults == 1
    assert s.invariant_checks == s.steps        # every iteration checked
    n = len(cs.fault_traffic(c))
    assert s.requests_done + s.requests_faulted + s.requests_canceled == n
    assert len(chaos_out) == s.requests_done == n - 2
    cs.drain_tiers(chaos)
