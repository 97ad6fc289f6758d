"""PyTorch port vs the JAX package: the JAX serving bench's fault storm
(``benchmarks/bench_serving.py``, part 5) and phase 16(a) of
``chip_smoke.py``.

At the bench's own shape (its 2-layer internlm2 config at vocab 256,
canvas 32, pages of 4, 41 pages, 4 slots, host tier of 16 pages in f32,
prefix index on, ``SPACache(rank=16, uniform, rho_peak=0.3,
refresh_interval=1)``, its six requests) the JAX engine and the port under
the storm give the same injector log, aborted uids, outputs and counters,
and those counters are ``chip_smoke.FAULT_STORM_RECORD`` (the bench's
``BENCH_serving.json["faults"]["storm"]``), which phase 16(a) asserts on
the card.  Phase 16(a)'s own functions, run here at 2 reduced LLaDA layers,
give the same counters, with survivors byte-identical to their clean pass.
"""
import json
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.core.strategy import SPACache as JSPACache
from repro.models import transformer
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.faults import FaultPlan as JFaultPlan

from _torch_parity import port_cfg, port_params, port_proxies

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)
SPEC = dict(rank=16, schedule="uniform", rho_peak=0.3, refresh_interval=1)


@pytest.fixture(scope="module")
def bench_model():
    cfg = reduced(get_arch("internlm2-1.8b"), n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                  vocab_size=256)
    return cfg, transformer.init_params(cfg, jax.random.PRNGKey(0))


def test_traffic_is_the_bench_workload(bench_model):
    """``fault_workload`` draws the bench's ``_workload`` (at x8 every
    prompt token repeated and every gen times 8)."""
    from benchmarks.bench_serving import _workload
    cfg, _ = bench_model
    want = _workload(cfg, 6)
    got = cs.fault_traffic(cs.FAULT_SMALL)
    assert [(p.tolist(), g, pri) for p, g, pri in got] == \
        [(p.tolist(), g, pri) for p, g, pri in want]
    big = cs.fault_workload(6, scale=8)
    assert [(p.tolist(), g, pri) for p, g, pri in big] == \
        [(np.repeat(p, 8).tolist(), 8 * g, pri) for p, g, pri in want]


def test_storm_counters_match_jax_and_the_record(bench_model):
    cfg, params = bench_model
    c = cs.FAULT_SMALL
    reqs = cs.fault_traffic(c)
    jeng = JEngine(cfg, params, max_batch=c["slots"], canvas_len=c["canvas"],
                   strategy=JSPACache(**SPEC), pool_pages=c["pool"],
                   page_size=c["page"], prefix_cache=True,
                   host_pages=c["host"], host_dtype="f32",
                   fault_plan=JFaultPlan(**cs.FAULT_STORM), supervise=True)
    jout, _ = cs.serve_faults(jeng, reqs)
    jcount, jfate = cs.fault_counters(jeng), cs.fault_outcome(jeng)
    tcfg = port_cfg(cfg)
    from repro_torch.core.strategy import SPACache
    tparams = port_params(params, tcfg)
    proxies = port_proxies(jeng._proxies_for(jeng.strategy), tcfg)
    clean_out, tout, tcount, tfate, _ = cs.storm_passes(
        tcfg, tparams, SPACache(**SPEC), proxies, device="cpu")
    assert tfate == jfate and tout == jout
    assert tcount == jcount == cs.FAULT_STORM_RECORD
    record = json.loads((ROOT / "BENCH_serving.json").read_text())
    assert {k: record["faults"]["storm"][k]
            for k in cs.FAULT_STORM_RECORD} == cs.FAULT_STORM_RECORD
    assert all(tout[i] == clean_out[i] for i in tout)      # survivors
    assert len(tout) == record["faults"]["survivor_count"]
    cs.drain_tiers(jeng)


def test_phase16a_functions_reproduce_the_record():
    """16(a)'s functions on a 2-layer reduced LLaDA (the plain kernels):
    the record's counters, and the survivors equal the clean pass."""
    from repro_torch.configs import get_arch as tget_arch
    from repro_torch.configs import reduced as treduced
    from repro_torch.core.strategy import SPACache
    from repro_torch.models import transformer as ttransformer
    cfg = treduced(tget_arch("llada-8b"), n_layers=2)
    params = ttransformer.init_params(cfg, seed=7, device="cpu")
    strat = SPACache(**SPEC)
    proxies = strat.build_proxies(params, cfg)
    runs = [cs.storm_passes(cfg, params, strat.with_backend(b), proxies,
                            device="cpu") for b in ("cuda", "torch")]
    clean, storm, counters, outcome, _ = runs[0]
    assert runs[1][:4] == runs[0][:4]
    assert counters == cs.FAULT_STORM_RECORD
    assert all(storm[i] == clean[i] for i in storm)
    assert outcome["aborted"] and outcome["log"]
