"""Phase 17's rehearsal, in the port: ``chip_smoke.py``'s own functions at
reduced widths on the CPU (the plain kernels).

17(b) serves six requests (one alone, its repeat and three more, a
priority-5 arrival on a short pool) through 3-layer RecurrentGemma and
Mamba2 engines, dense and paged with the prefix index, on both backends.
Its scheduling follows commits and admissions, not widths, so the CPU run
gives the counters the card printed (``RECURRENT_COUNTERS``).  17(a)'s
profiled server, probes and ``serve --profile --torch-trace-dir`` run
through the same code as on the card.
"""
import dataclasses
import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

# (steps, swaps, preemptions, done, hits, full hits, published) of 17(b)
RECURRENT_COUNTERS = {
    ("hybrid", "dense"): (32, 1, 0, 6, 0, 0, 0),
    ("hybrid", "paged"): (26, 2, 1, 6, 1, 1, 4),
    ("mamba2", "dense"): (32, 1, 0, 6, 0, 0, 0),
    ("mamba2", "paged"): (26, 2, 1, 6, 0, 0, 0),
}


def test_phase17b_rehearsal_gives_the_counters():
    from repro_torch.configs import get_arch, reduced
    cfgs = {name: dataclasses.replace(reduced(get_arch(arch), n_layers=3),
                                      param_dtype="float32")
            for name, arch in (("hybrid", "recurrentgemma-9b"),
                               ("mamba2", "mamba2-370m"))}
    records = cs.recurrent_exactness(torch, cfgs, device="cpu")
    got = {key: tuple(rec["counters"].values())
           for key, rec in records.items()}
    assert got == RECURRENT_COUNTERS


def test_phase17a_rehearsal(monkeypatch, tmp_path, capsys):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.strategy import SPACache
    from repro_torch.kernels import _lib
    from repro_torch.models import transformer
    monkeypatch.setattr(_lib, "BUILD_DIR", tmp_path)
    cfg = reduced(get_arch("llada-8b"), n_layers=4)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    strat = SPACache.from_spec(cfg.spa)
    cut = cs.llada_cut(cfg, params, strat.build_proxies(params, cfg),
                       layers=2)
    cs.profiling_serving(torch, *cut, device="cpu")
    out = capsys.readouterr().out
    assert "outputs identical" in out
    for phase in cs.PROBE_KERNELS:
        assert f"probe {phase:>11}" in out
    assert "serve: served 4 requests" in out
    assert (tmp_path / "trace17" / "trace.json").exists()
