"""PyTorch port vs the JAX package: the paged ServingEngine with the
shared-prefix index, part 1.

The port's engine (``CudaBackend``, plain versions on the CPU) and the JAX
engine serve the same requests with the same weights and singular proxies;
the bar is identical outputs for every uid, equal engine counters, equal
``prefix_*`` counters and index holds (``_torch_parity.assert_engines_match``).
Scenarios mirror ``tests/test_prefix.py``'s engine tests and the JAX
``benchmarks/bench_serving.py`` shared-system-prompt traffic;
``tests/test_torch_prefix_admission.py`` holds the admission cases.
"""
import numpy as np
import torch

from repro.core.strategy import SPACache as JSPACache

from _torch_parity import assert_engines_match, engine_pair, serve_both
from repro_torch.core.strategy import SPACache as TSPACache

torch.set_num_threads(1)
PAGE, CANVAS = 4, 16
N_LOG = CANVAS // PAGE


def _strategies():
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3)
    return JSPACache(**spec), TSPACache(**spec)


def _kw(pool_pages, max_batch=2):
    return dict(max_batch=max_batch, canvas_len=CANVAS,
                pool_pages=pool_pages, page_size=PAGE, prefix_cache=True)


def test_shared_system_prompt_matches_jax(tiny_cfg, tiny_params):
    """One 8-token system prompt, three 2-token questions each asked twice
    (gen 6): the third question partial-hits the system prompt's pages
    and the repeats full-hit.  Outputs and every prefix counter equal the
    JAX engine's.  The first question's repeat attaches the run its first
    asking published whole, so it decodes the same tokens; the other
    repeats attach the system prompt's pages from the first question's
    canvas (first publisher wins), so they carry no such guarantee."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, tiny_cfg.vocab_size - 1, 8).astype(np.int32)
    questions = [rng.integers(0, tiny_cfg.vocab_size - 1, 2)
                 .astype(np.int32) for _ in range(3)]
    reqs = [(np.concatenate([system, questions[i % 3]]), 6, 0)
            for i in range(6)]
    jeng, teng = serve_both(tiny_cfg, tiny_params, reqs,
                            strategies=_strategies(),
                            **_kw(1 + 6 * N_LOG, max_batch=2))
    out = assert_engines_match(jeng, teng)
    assert (teng.stats.prefix_hits, teng.stats.prefix_full_hits) == (4, 3)
    np.testing.assert_array_equal(out[3], out[0])


def test_multiturn_extension_matches_jax(tiny_cfg, tiny_params):
    """A growing transcript with a reserved row span: the second turn
    partial-hits the first's pages, the third (the second resubmitted)
    full-hits; as in the JAX engine."""
    rng = np.random.default_rng(1)
    p1 = rng.integers(0, tiny_cfg.vocab_size - 1, 8).astype(np.int32)
    p2 = np.concatenate([p1, rng.integers(0, tiny_cfg.vocab_size - 1, 4)
                         .astype(np.int32)])
    jeng, teng = engine_pair(tiny_cfg, tiny_params, _strategies(),
                             **_kw(64))
    for eng in (jeng, teng):
        for prompt in (p1, p2, p2):
            eng.submit(prompt, gen_len=4, row_len=CANVAS)
            eng.run()
    assert_engines_match(jeng, teng)
    assert teng.stats.prefix_hits == 2
    assert teng.stats.prefix_full_hits == 1
    assert teng.stats.prefix_tokens_saved == 8 + CANVAS


def test_preemption_with_prefix_cache_matches_jax(tiny_cfg, tiny_params):
    """Preempt and resume on a tight pool with the index competing for
    pages: the same outputs and counters as the JAX engine, and the same
    outputs as the port's engine with the index off."""
    rng = np.random.default_rng(7)
    smalls = [rng.integers(0, tiny_cfg.vocab_size - 1, 4).astype(np.int32)
              for _ in range(2)]
    big = rng.integers(0, tiny_cfg.vocab_size - 1, 8).astype(np.int32)
    reqs = [(p, 4, 0) for p in smalls]

    def late(e, submit):
        if e.stats.steps == 2:
            submit(big, 8, 5)

    jeng, teng = serve_both(tiny_cfg, tiny_params, reqs,
                            strategies=_strategies(), on_step=late,
                            **_kw(5))
    on = assert_engines_match(jeng, teng)
    assert teng.stats.preemptions > 0
    from repro_torch.serving.engine import ServingEngine as TEngine
    off = TEngine(teng.cfg, teng.params, strategy=teng.strategy,
                  device="cpu", **dict(_kw(5), prefix_cache=False))
    off._proxies = teng._proxies
    for p, g, _ in reqs:
        off.submit(p, gen_len=g)

    def late_off(e):
        if e.stats.steps == 2:
            e.submit(big, gen_len=8, priority=5)

    off.run(on_step=late_off)
    for r in off.done:
        np.testing.assert_array_equal(r.output, on[r.uid])


def test_serve_cli_prefix_cache_in_process(capsys):
    """The offline CLI, paged, prefix cache on by default: the repeats of
    the distinct prompts full-hit (3 hits, 17 pages published: the JAX
    launcher's registry reads the same for these flags)."""
    from repro_torch.launch import serve as tserve
    assert tserve.main(["--device", "cpu", "--arch", "internlm2-1.8b",
                        "--requests", "6", "--gen-len", "6", "--canvas",
                        "24", "--max-batch", "2", "--pool-pages", "30",
                        "--page-size", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 6 requests, 36 tokens" in out
    assert "prefix: 3 hits (3 full), 68 prefill rows saved, 17 pages " \
        "published (0 skipped)" in out
