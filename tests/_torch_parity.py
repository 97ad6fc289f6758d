"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made once, with numpy or the JAX package, and handed to both
packages as numpy arrays; the port runs on the CPU (``device="cpu"``),
single-threaded because the suite runs under several xdist workers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch import weights
from repro_torch.dlm.scheduler import Draws


def port_cfg(cfg):
    """The JAX package's ModelConfig -> the port's (same field values)."""
    from repro_torch.configs.base import MoEConfig as TMoE
    from repro_torch.configs.base import RGLRUConfig as TRGLRU
    from repro_torch.configs.base import SPAConfig as TSPA
    from repro_torch.configs.base import SSMConfig as TSSM
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["spa"] = TSPA(**dataclasses.asdict(cfg.spa))
    if cfg.rglru is not None:
        fields["rglru"] = TRGLRU(**dataclasses.asdict(cfg.rglru))
    if cfg.ssm is not None:
        fields["ssm"] = TSSM(**dataclasses.asdict(cfg.ssm))
    if cfg.moe is not None:
        fields["moe"] = TMoE(**dataclasses.asdict(cfg.moe))
    return tconfigs.ModelConfig(**fields)


def port_params(params, tcfg):
    return weights.from_numpy_params(jax.tree.map(np.asarray, params),
                                     tcfg, "cpu")


def port_proxies(proxies, tcfg):
    return weights.from_numpy_proxies(jax.tree.map(np.asarray, proxies),
                                      tcfg, "cpu")


def np32(x):
    """Any array or tensor -> float32 numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def decode_both(cfg, params, prompt, gen, jstrat, tstrat, *, backend=None,
                jsched=None, tsched=None, jrng=None, trng=None,
                settings=None, tsettings=None, max_steps=None):
    """Decode ``prompt`` (numpy [B, P]) + ``gen`` [MASK] slots through the
    JAX ``DecodeSession.run`` (XlaBackend) and the port's (CPU), with the
    same weights and proxies (``max_steps`` steps at most).  Returns (JAX tokens, JAX info, JAX cache as
    numpy, port tokens as numpy, port info, port session)."""
    from repro.dlm.session import DecodeSession as JSession
    from repro_torch.dlm.session import DecodeSession as TSession
    from repro_torch.kernels.backend import TORCH_BACKEND
    js = JSession(params, cfg, strategy=jstrat, scheduler=jsched,
                  settings=settings)
    js.prefill(jnp.asarray(prompt), gen, rng=jrng)
    j_toks, j_info = js.run(max_steps)
    tcfg = port_cfg(cfg)
    proxies = (port_proxies(js.spa_proxies, tcfg)
               if js.spa_proxies is not None else None)
    ts = TSession(port_params(params, tcfg), tcfg, strategy=tstrat,
                  spa_proxies=proxies, backend=backend or TORCH_BACKEND,
                  scheduler=tsched, settings=tsettings, device="cpu")
    ts.prefill(torch.from_numpy(np.asarray(prompt)), gen, rng=trng)
    t_toks, t_info = ts.run(max_steps)
    return (np.asarray(j_toks), j_info,
            jax.tree.map(np.asarray, js.state.cache), t_toks.numpy(),
            t_info, ts)


class ReplayDraws(Draws):
    """Recorded draws handed out in order, whatever their kind; a draw
    whose shape differs from the request raises."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.used = 0

    def _next(self, shape, device):
        out = torch.tensor(self.draws[self.used], dtype=torch.float32,
                           device=device)
        self.used += 1
        assert tuple(out.shape) == tuple(shape), (out.shape, shape)
        return out

    uniform = gumbel = _next


def jax_draws(name, seed, steps, b, c, v):
    """The draws the JAX decode makes from PRNGKey(seed): per step the
    state's key splits into (next, step); temperature splits the step key
    into (k_pos, k_tok) and draws Gumbel noise for the tokens [B, C, V]
    and the positions [B, C]; random_order draws a uniform [B, C] from
    the step key.  In the order the port's schedulers ask for them."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, step = jax.random.split(key)
        if name == "temperature":
            k_pos, k_tok = jax.random.split(step)
            out.append(np.asarray(jax.random.gumbel(k_tok, (b, c, v),
                                                    jnp.float32)))
            out.append(np.asarray(jax.random.gumbel(k_pos, (b, c),
                                                    jnp.float32)))
        else:
            out.append(np.asarray(jax.random.uniform(step, (b, c))))
    return out


def assert_caches_close(j_cache, t_cache):
    """The same buffers; float ones within rtol/atol 1e-4 (f32 sums in
    another order, ~1e-6 after a decode), int8 codes within 1."""
    assert sorted(j_cache) == sorted(t_cache)
    for kind, bufs in j_cache.items():
        assert sorted(bufs) == sorted(t_cache[kind])
        for name, a in bufs.items():
            t = t_cache[kind][name]
            if a.dtype == np.int8:
                assert np.abs(a.astype(np.int32)
                              - t.numpy().astype(np.int32)).max() <= 1, name
            else:
                np.testing.assert_allclose(t.float().numpy(),
                                           a.astype(np.float32),
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=f"{kind}/{name}")


def engine_pair(cfg, params, strategies, jextra=None, textra=None, **kw):
    """The JAX engine and the port's (CPU) on the same weights, both
    scoring with the JAX strategy's proxies (when it builds any), with the
    same engine arguments (``jextra`` / ``textra``: arguments of one side
    only, such as each package's SLO policy, clock or telemetry).  Returns
    (JAX engine, port engine)."""
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.serving.engine import ServingEngine as TEngine
    jeng = JEngine(cfg, params, strategy=strategies[0], **kw,
                   **(jextra or {}))
    tcfg = port_cfg(cfg)
    teng = TEngine(tcfg, port_params(params, tcfg), strategy=strategies[1],
                   device="cpu", **kw, **(textra or {}))
    jprox = jeng._proxies_for(jeng.strategy)
    if jprox is not None:
        teng._proxies[teng.strategy] = port_proxies(jprox, tcfg)
    return jeng, teng


def serve_both(cfg, params, requests, *, strategies, on_step=None, **kw):
    """Serve the same requests through the JAX engine and the port's.

    ``requests``: (prompt, gen_len, priority) triples submitted up front;
    ``strategies``: (JAX strategy, port strategy); ``on_step(engine,
    submit)`` may submit more through ``submit(prompt, gen_len, priority)``
    at the same engine step in both runs.  The port engine scores with the
    JAX engine's singular proxies.  Returns (JAX engine, port engine)."""

    def run(engine):
        for prompt, gen, prio in requests:
            engine.submit(prompt, gen_len=gen, priority=prio)
        hook = None
        if on_step is not None:
            def hook(e):
                on_step(e, lambda p, g, prio=0: e.submit(p, gen_len=g,
                                                         priority=prio))
        engine.run(on_step=hook)
        return engine

    jeng, teng = engine_pair(cfg, params, strategies, **kw)
    return run(jeng), run(teng)


def slo_engines(cfg, params, policy, page=4, canvas=16):
    """The JAX and the port engine of the JAX ``tests/test_slo.py`` (2
    slots, canvas 16, pages of 4, a pool of 2 canvases + 1, SPACache with
    ``refresh_interval=1``), each with its package's ``StepClock`` and
    ``SLOPolicy(**policy)`` (none for ``policy=None``).  Returns ((JAX
    engine, clock, slo module), (port engine, clock, slo module))."""
    from repro.core.strategy import SPACache as JSPACache
    from repro.serving import slo as jslo
    from repro_torch.core.strategy import SPACache as TSPACache
    from repro_torch.serving import slo as tslo
    jclock, tclock = jslo.StepClock(), tslo.StepClock()
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3,
                refresh_interval=1)
    jpol = tpol = None
    if policy is not None:
        jpol, tpol = jslo.SLOPolicy(**policy), tslo.SLOPolicy(**policy)
    jeng, teng = engine_pair(
        cfg, params, (JSPACache(**spec), TSPACache(**spec)),
        jextra=dict(slo_policy=jpol, clock=jclock),
        textra=dict(slo_policy=tpol, clock=tclock),
        max_batch=2, canvas_len=canvas,
        pool_pages=2 * (canvas // page) + 1, page_size=page)
    return (jeng, jclock, jslo), (teng, tclock, tslo)


def assert_slo_runs_match(jeng, teng):
    """Two engines' runs of one SLO scenario: the same outputs, shed and
    canceled sets, admission / first-token / completion times, counters
    and TTFT / TPOT percentiles, and both pools empty."""
    j = {r.uid: r for r in jeng.done}
    t = {r.uid: r for r in teng.done}
    assert sorted(j) == sorted(t)
    for uid, jr in j.items():
        tr = t[uid]
        assert (tr.shed, tr.canceled) == (jr.shed, jr.canceled), uid
        assert (tr.started_at, tr.first_token_at, tr.completed_at) \
            == (jr.started_at, jr.first_token_at, jr.completed_at), uid
        if jr.output is None:
            assert tr.output is None, uid
        else:
            np.testing.assert_array_equal(tr.output, np.asarray(jr.output))
    for name in ("steps", "preemptions", "requests_done", "requests_shed",
                 "slo_met", "slo_missed", "tokens_committed", "swaps"):
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.stats.percentiles() == jeng.stats.percentiles()
    assert teng.pool.used == jeng.pool.used == 0


ENGINE_STATS = ("steps", "swaps", "preemptions", "requests_done",
                "admission_stalls")
PREFIX_STATS = ("prefix_hits", "prefix_full_hits", "prefix_tokens_saved",
                "prefix_published", "prefix_publish_skipped",
                "prefix_evicted_pages", "prefix_demoted_pages",
                "prefix_dropped_pages", "prefix_promoted_pages",
                "prefix_promotions", "promotion_stalls", "peak_host_util",
                "host_checksum_failures", "cold_prefill_fallbacks")


def assert_engines_match(jeng, teng):
    """Identical outputs for every uid, equal engine counters (with a
    prefix index, its counters and the host tier's too, and the same held
    pages), and (paged) a pool drained down to the index's holds on both
    sides; with a host tier, a host pool holding exactly the index's refs."""
    j_out = {r.uid: np.asarray(r.output) for r in jeng.done}
    t_out = {r.uid: np.asarray(r.output) for r in teng.done}
    assert sorted(j_out) == sorted(t_out)
    for uid, out in j_out.items():
        np.testing.assert_array_equal(t_out[uid], out, err_msg=f"uid {uid}")
    names = ENGINE_STATS + (PREFIX_STATS if teng.prefix is not None else ())
    for name in names:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    if teng.pool is not None:
        held = 0
        if teng.prefix is not None:
            held = teng.prefix.held_pages
            assert held == jeng.prefix.held_pages
        assert teng.pool.used == held
        assert jeng.pool.used == held
    if teng.host_pool is not None:
        host = teng.prefix.host_held_pages
        assert host == jeng.prefix.host_held_pages
        assert teng.host_pool.used_pages == host
        assert jeng.host_pool.used_pages == host
    return t_out


def hybrid_cfg():
    """A reduced RecurrentGemma of 6 layers ((rglru, rglru, local) twice:
    attention at layers 2 and 5, window 64) whose SPA schedule gives, at
    N = 16384 (4 strata), k = 848 at layer 2 (stratified, q_span 16384:
    the dense grid) and k = 4096 at layer 5 (q_span 8192: the banded
    grid); at N = 12288 (3 strata), k_eff = 639 (640 // 3 * 3 rows, q_span
    16384: the dense grid) and 3072 (q_span 8192: the banded grid); a
    short canvas stratifies nothing."""
    from repro.configs import get_arch, reduced
    cfg = reduced(get_arch("recurrentgemma-9b"), n_layers=6)
    return dataclasses.replace(cfg, spa=dataclasses.replace(
        cfg.spa, layer_peak=6, rho_first=0.003))


def hybrid_strategies(cfg, name):
    """(JAX strategy, port strategy) of one name, built the same way in
    both packages from the config's spec: ``singular``, ``incremental``
    (SPACache with the incremental identifier) or ``attn_out``."""
    from repro.core import strategy as jstrategy
    from repro_torch.core import strategy as tstrategy
    tspec = port_cfg(cfg).spa
    if name == "incremental":
        return (dataclasses.replace(jstrategy.SPACache.from_spec(cfg.spa),
                                    incremental_ident=True),
                dataclasses.replace(tstrategy.SPACache.from_spec(tspec),
                                    incremental_ident=True))
    return (jstrategy.strategy_from_spec(
                dataclasses.replace(cfg.spa, identifier=name)),
            tstrategy.strategy_from_spec(
                dataclasses.replace(tspec, identifier=name)))


def grid_recorder():
    """A TorchBackend that logs every attention call as (kq, q_span the
    kernel sees, banded grid engaged, gathered queries)."""
    from repro_torch.kernels import sparse_attention as tsa
    from repro_torch.kernels.backend import TorchBackend

    @dataclasses.dataclass(frozen=True)
    class GridRecorder(TorchBackend):
        log: list = dataclasses.field(default_factory=list, compare=False,
                                      hash=False)

        def attention(self, q, k, v, *, q_positions=None, window=0,
                      banded=False, q_span=0, **kw):
            span = q_span if q_positions is not None else min(512,
                                                              q.shape[1])
            self.log.append((q.shape[1], span, tsa.banded_engages(
                k.shape[1], window, banded, span), q_positions is not None))
            return super().attention(q, k, v, q_positions=q_positions,
                                     window=window, banded=banded,
                                     q_span=q_span, **kw)

    return GridRecorder()


def long_hybrid_parity(name, n=12288, gen=8, steps=2):
    """The reduced hybrid (``hybrid_cfg``) at a long canvas, B = 2, for a
    few steps under one identifier, through both packages; the port on a
    ``grid_recorder`` backend.  Asserts identical tokens and step counts
    and caches within 1e-4; returns the recorder's log."""
    import jax
    from repro.models import transformer as jt
    cfg = hybrid_cfg()
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(3).integers(0, cfg.vocab_size - 1,
                                               (2, n - gen))
    jstrat, tstrat = hybrid_strategies(cfg, name)
    rec = grid_recorder()
    j_toks, j_info, j_cache, t_toks, t_info, sess = decode_both(
        cfg, params, prompt, gen, jstrat, tstrat, backend=rec,
        max_steps=steps)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"] == steps
    assert_caches_close(j_cache, sess.state.cache)
    return rec.log


# Reduced dense configs that keep what makes each model its own: GQA group,
# head_dim, proxy rank, windows and the cache dtype.
DENSE_OVERRIDES = {
    "dream-7b": dict(n_heads=7, n_kv_heads=1, head_dim=128),
    "deepseek-67b": dict(n_heads=8, n_kv_heads=1, head_dim=128,
                         cache_dtype="int8"),
    "gemma2-2b": dict(n_heads=4, n_kv_heads=2, head_dim=256),
    "h2o-danube-3-4b": dict(n_heads=8, n_kv_heads=2, head_dim=120),
}


def dense_cfg(name, n_layers=2):
    """``reduced()`` of a dense config with :data:`DENSE_OVERRIDES`, the
    config's own proxy rank and its windows cut to 64."""
    from repro.configs import get_arch, reduced
    cfg = get_arch(name)
    return reduced(cfg, n_layers=n_layers, spa=cfg.spa,
                   **DENSE_OVERRIDES[name])


def dense_strategies(cfg, name):
    """(JAX strategy, port strategy) built from the config's spec:
    ``singular`` (its own adaptive schedule), a baseline identifier, or
    ``none`` (NoCache)."""
    from repro.core import strategy as jstrategy
    from repro_torch.core import strategy as tstrategy
    tspec = port_cfg(cfg).spa
    return (jstrategy.strategy_from_spec(
                dataclasses.replace(cfg.spa, identifier=name)),
            tstrategy.strategy_from_spec(
                dataclasses.replace(tspec, identifier=name)))


def dense_decode_parity(cfg, params, prompt, gen, name, backend=None):
    """One decode of ``cfg`` under strategy ``name`` through both packages:
    identical tokens and step counts, caches within 1e-4 (int8 codes
    within 1).  Returns the port session."""
    jstrat, tstrat = dense_strategies(cfg, name)
    j_toks, j_info, j_cache, t_toks, t_info, sess = decode_both(
        cfg, params, prompt, gen, jstrat, tstrat, backend=backend)
    np.testing.assert_array_equal(t_toks, j_toks)
    assert t_info["steps"] == j_info["steps"]
    assert_caches_close(j_cache, sess.state.cache)
    return sess


# -- fault injection and supervision ------------------------------------

FAULT_STATS = ("steps", "tokens_committed", "swaps", "preemptions",
               "requests_done", "requests_faulted", "requests_canceled",
               "requests_shed", "faults_injected", "alloc_faults",
               "host_checksum_failures", "cold_prefill_fallbacks",
               "nan_quarantines", "disconnect_bursts", "watchdog_fires",
               "invariant_checks", "publish_paused_skips", "degrade_level",
               "degradations", "restorations", "degradation_events")


def fault_engines(cfg, params, *, plan=None, sup=None, canvas=16, page=4,
                  **kw):
    """The JAX engine and the port's of the JAX ``tests/test_faults.py``
    (``SPACache(rank=16, uniform, rho_peak=0.3, refresh_interval=1)``,
    canvas 16, pages of 4, host tier in f32 when ``host_pages`` is given),
    each with its own package's ``FaultPlan(**plan)`` and
    ``SupervisorConfig(**sup)`` and a tracer (no cache dynamics) whose
    fault instants :func:`assert_fault_runs_match` compares.  ``kw``: engine arguments of both (``max_batch``,
    ``pool_pages``, ``prefix_cache``, ``supervise``, ...)."""
    from repro.core.strategy import SPACache as JSPACache
    from repro.serving import faults as jfaults
    from repro.serving import supervisor as jsup
    from repro.serving import telemetry as jtel
    from repro_torch.core.strategy import SPACache as TSPACache
    from repro_torch.serving import faults as tfaults
    from repro_torch.serving import supervisor as tsup
    from repro_torch.serving import telemetry as ttel
    spec = dict(rank=16, schedule="uniform", rho_peak=0.3,
                refresh_interval=1)
    jextra, textra = {}, {}
    for extra, faults, supmod, tel in ((jextra, jfaults, jsup, jtel),
                                       (textra, tfaults, tsup, ttel)):
        if plan is not None:
            extra["fault_plan"] = faults.FaultPlan(**plan)
        if sup is not None:
            extra["supervisor_cfg"] = supmod.SupervisorConfig(**sup)
        extra["telemetry"] = tel.Telemetry(tracer=tel.Tracer(enabled=True))
    kw.setdefault("max_batch", 2)
    kw.setdefault("host_dtype", "f32")
    return engine_pair(cfg, params, (JSPACache(**spec), TSPACache(**spec)),
                       jextra=jextra, textra=textra, canvas_len=canvas,
                       page_size=page, **kw)


def fault_instants(engine):
    """The trace's ``fault:*`` and ``ladder`` instants as (name, args)."""
    return [(e.name, e.args) for e in engine.telemetry.tracer.events
            if e.ph == "i" and (e.name.startswith("fault:")
                                or e.name == "ladder")]


def fault_outcomes(engine):
    """uid -> (fault, canceled, shed, output bytes or None)."""
    return {r.uid: (r.fault, r.canceled, r.shed,
                    None if r.output is None
                    else np.asarray(r.output).astype(np.int32).tobytes())
            for r in engine.done}


def assert_fault_runs_match(jeng, teng):
    """One fault scenario through both engines: the same injector log, the
    same done / faulted / canceled / shed uids and outputs, the same fault
    counters (``FAULT_STATS``; the tier's refused stores and corrupt pages
    against the JAX tier manager's counters), the same ``fault:*`` and
    ``ladder`` trace instants, and the same pages held on both tiers.
    Returns the port's outcomes."""
    if jeng.faults is not None:
        assert teng.faults.log == jeng.faults.log
        assert teng.faults.fired == jeng.faults.fired
    out = fault_outcomes(teng)
    assert out == fault_outcomes(jeng)
    for name in FAULT_STATS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    if jeng.tier is not None:
        assert teng.stats.tier_store_faults == jeng.tier.store_faults
        assert teng.stats.host_corrupt_pages == jeng.tier.checksum_failures
        tier = teng.pool_debug_state()["tier"]
        assert tier["store_faults"] == jeng.tier.store_faults
    assert fault_instants(teng) == fault_instants(jeng)
    if teng.pool is not None:
        held = teng.prefix.held_pages if teng.prefix is not None else 0
        assert teng.pool.used == jeng.pool.used == held
        assert teng.pool.refcounts == jeng.pool.refcounts
    if teng.host_pool is not None:
        assert (teng.host_pool.used_pages == jeng.host_pool.used_pages
                == teng.prefix.host_held_pages)
    return out


def pressure_cycle(eng, cfg):
    """cold(p0) -> eviction of p0's entry under pool pressure (demote) ->
    warm(p0) (promote).  Returns (cold output, warm output)."""
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size - 1, 8).astype(np.int32)
               for _ in range(3)]
    u = eng.submit(prompts[0], gen_len=8)
    eng.run()
    cold = next(r for r in eng.done if r.uid == u).output
    for p in prompts[1:]:
        eng.submit(p, gen_len=8)
    eng.run()
    u = eng.submit(prompts[0], gen_len=8)
    eng.run()
    warm = next(r for r in eng.done if r.uid == u).output
    return np.asarray(cold), np.asarray(warm)


def cycle_both_tiers(cfg, params, site):
    """The JAX ``tests/test_faults.py`` host-tier scenario through both
    engines (pool of 9 pages, host tier of 16 pages in f32, prefix index
    on) under a plan firing ``site`` at its first probe: the pressure
    cycle's warm output equals its cold one and JAX's, and the runs match
    (``assert_fault_runs_match``).  Returns (JAX engine, port engine)."""
    jeng, teng = fault_engines(cfg, params, pool_pages=9, host_pages=16,
                               prefix_cache=True,
                               plan=dict(at={site: (0,)}))
    (jcold, jwarm), (tcold, twarm) = (pressure_cycle(e, cfg)
                                      for e in (jeng, teng))
    assert_fault_runs_match(jeng, teng)
    np.testing.assert_array_equal(tcold, twarm)
    np.testing.assert_array_equal(tcold, jcold)
    np.testing.assert_array_equal(twarm, jwarm)
    return jeng, teng


RECURRENT_CANVAS, RECURRENT_PAGE, RECURRENT_POOL = 24, 4, 13


def recurrent_cfg(name):
    """The reduced recurrent stacks the engine tests serve: ``hybrid``, a
    RecurrentGemma of 3 layers (rglru, rglru, local), or ``ssd``, a Mamba2
    of 2 layers."""
    from repro.configs import get_arch, reduced
    if name == "hybrid":
        return reduced(get_arch("recurrentgemma-9b"), n_layers=3)
    return reduced(get_arch("mamba2-370m"), n_layers=2)


def recurrent_churn(eng, cfg):
    """A prompt served alone (a paged run publishes it), then its repeat,
    two more prompts (gen 12 and 16) and a priority-5 request two steps
    in: slot swaps, a preemption, and with the prefix index a full hit."""
    rng = np.random.default_rng(0)
    hi = cfg.vocab_size - 1
    p0, p1, p2, p3 = (rng.integers(0, hi, n).astype(np.int32)
                      for n in (8, 6, 8, 8))
    eng.submit(p0, gen_len=8)
    eng.run()
    for p, g in ((p0, 8), (p1, 12), (p2, 16)):
        eng.submit(p, gen_len=g)
    s0, late = eng.stats.steps, [p3]

    def on_step(e):
        if late and e.stats.steps >= s0 + 2:
            e.submit(late.pop(), gen_len=8, priority=5)

    eng.run(on_step=on_step)
    return eng


def recurrent_lanes_match(name, mode):
    """``recurrent_churn`` through the JAX engine and the port's on one
    reduced recurrent stack, in ``mode``: ``dense`` lanes, ``paged`` lanes
    (pool of 13 pages of 4, canvas 24) or ``prefix`` (paged, prefix index
    on).  Asserts equal outputs, steps, swaps, preemptions and prefix
    counters (``assert_engines_match``), slot swaps and (paged: the pool
    is short) a preemption.  Returns (JAX engine, port engine)."""
    from repro.core import strategy as jstrategy
    from repro.models import transformer as jt
    from repro_torch.core import strategy as tstrategy
    cfg = recurrent_cfg(name)
    kw = dict(max_batch=2, canvas_len=RECURRENT_CANVAS)
    if mode != "dense":
        kw.update(pool_pages=RECURRENT_POOL, page_size=RECURRENT_PAGE,
                  prefix_cache=mode == "prefix")
    jeng, teng = engine_pair(
        cfg, jt.init_params(cfg, jax.random.PRNGKey(0)),
        (jstrategy.strategy_from_spec(cfg.spa),
         tstrategy.strategy_from_spec(port_cfg(cfg).spa)), **kw)
    for eng in (jeng, teng):
        recurrent_churn(eng, cfg)
    assert_engines_match(jeng, teng)
    assert teng.stats.swaps > 0
    assert (teng.stats.preemptions > 0) == (mode != "dense")
    assert teng.stats.requests_done == 5
    return jeng, teng


# -- MoE ------------------------------------------------------------------

MOE_CFGS = {
    # Mixtral: SWA layers (window cut to 64), f32 cache
    "mixtral-8x22b": {},
    # Qwen3-MoE: its int8 cache (int8 K/V attention on the decode path)
    "qwen3-moe-235b-a22b": {"cache_dtype": "int8"},
}


def moe_model(name, p_len):
    """(cfg, JAX params, prompt [2, p_len]) of a reduced 2-layer MoE config
    (4 experts, top-2) with :data:`MOE_CFGS`' overrides."""
    from repro.configs import get_arch, reduced
    from repro.models import transformer as jt
    cfg = reduced(get_arch(name), n_layers=2, **MOE_CFGS[name])
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    prompt = np.random.default_rng(3).integers(
        0, cfg.vocab_size - 1, (2, p_len)).astype(np.int32)
    return cfg, params, prompt
