"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made once, with numpy or the JAX package, and handed to both
packages as numpy arrays; the port runs on the CPU (``device="cpu"``),
single-threaded because the suite runs under several xdist workers.
"""
import dataclasses

import jax
import numpy as np
import torch

from repro_torch import configs as tconfigs
from repro_torch import weights


def port_cfg(cfg):
    """The JAX package's ModelConfig -> the port's (same field values)."""
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
    assert fields["moe"] is None, "moe configs are not ported yet"
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
    import jax.numpy as jnp
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


def serve_both(cfg, params, requests, *, strategies, on_step=None, **kw):
    """Serve the same requests through the JAX engine and the port's.

    ``requests``: (prompt, gen_len, priority) triples submitted up front;
    ``strategies``: (JAX strategy, port strategy); ``on_step(engine,
    submit)`` may submit more through ``submit(prompt, gen_len, priority)``
    at the same engine step in both runs.  The port engine scores with the
    JAX engine's singular proxies.  Returns (JAX engine, port engine)."""
    from repro.serving.engine import ServingEngine as JEngine
    from repro_torch.serving.engine import ServingEngine as TEngine

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

    jeng = run(JEngine(cfg, params, strategy=strategies[0], **kw))
    tcfg = port_cfg(cfg)
    teng = TEngine(tcfg, port_params(params, tcfg), strategy=strategies[1],
                   device="cpu", **kw)
    jprox = jeng._proxies.get(jeng.strategy)
    if jprox is not None:
        teng._proxies[teng.strategy] = port_proxies(jprox, tcfg)
    return jeng, run(teng)


ENGINE_STATS = ("steps", "swaps", "preemptions", "requests_done",
                "admission_stalls")


def assert_engines_match(jeng, teng):
    """Identical outputs for every uid, equal engine counters, and (paged)
    a drained pool on both sides."""
    j_out = {r.uid: np.asarray(r.output) for r in jeng.done}
    t_out = {r.uid: np.asarray(r.output) for r in teng.done}
    assert sorted(j_out) == sorted(t_out)
    for uid, out in j_out.items():
        np.testing.assert_array_equal(t_out[uid], out, err_msg=f"uid {uid}")
    for name in ENGINE_STATS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    if teng.pool is not None:
        assert teng.pool.available == teng.pool.capacity
        assert jeng.pool.available == jeng.pool.capacity
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
