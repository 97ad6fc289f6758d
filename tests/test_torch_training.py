"""PyTorch port vs the JAX package: training.

On the same weights, batch and masking (the JAX side draws its masking
from ``jax.random``; the port takes it as given), in f32:
``diffusion_loss``, its gradients and one ``adamw_update`` agree within
1e-4 for a dense config, a MoE config (the router's aux loss in the
total) and InternVL2's vision stub; ``encoder_loss`` for HuBERT with the
frame mask passed in; ``train_step`` with 4 interleaved microbatches
against the JAX step and against the port's full batch; ``lr_at``; the
synthetic data pipelines array for array; the JAX ``test_training.py``
quadratic; a short ``Trainer.fit`` whose loss falls; the launcher.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.data import synthetic as jdata
from repro.dlm import loss as jloss
from repro.dlm.noise import sample_masking as jmasking
from repro.models import transformer as jt
from repro.training import optimizer as jopt
from repro.training import trainer as jtrainer

from _torch_parity import np32, port_cfg, port_params
from repro_torch.data import synthetic as tdata
from repro_torch.dlm import loss as tloss
from repro_torch.training import optimizer as topt
from repro_torch.training import trainer as ttrainer

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
OPT = dict(warmup_steps=1, total_steps=100)
ARCHS = {"dense": "internlm2-1.8b", "moe": "mixtral-8x22b",
         "vision": "internvl2-76b"}


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _tbatch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _jax_step(cfg, params, batch, rng, loss_fn):
    """JAX loss, grads and one AdamW update from a fresh state."""
    (loss, metrics), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True), static_argnums=(1,))(
        params, cfg, batch, rng)
    new, state, om = jopt.adamw_update(jopt.AdamWConfig(**OPT), params,
                                       grads, jopt.init_opt_state(params))
    return loss, metrics, grads, new, state


def _port_step(cfg, params, batch, loss_fn, masking):
    tcfg = port_cfg(cfg)
    tp = port_params(params, tcfg)
    leaves = topt.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(tp, tcfg, _tbatch(batch), masking=masking)
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    gtree = topt.tree_unflatten(tp, grads)
    new, state, om = topt.adamw_update(topt.AdamWConfig(**OPT), tp, gtree,
                                       topt.init_opt_state(tp))
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, gtree, new, state


@pytest.fixture(scope="module")
def diffusion_runs():
    """Each config's JAX and port loss / grads / AdamW step (once)."""
    out = {}
    for key, arch in ARCHS.items():
        cfg = reduced(get_arch(arch), n_layers=2)
        params = jt.init_params(cfg, jax.random.PRNGKey(0))
        batch = next(jdata.token_batches(cfg, 4, 24, seed=0))
        rng = jax.random.PRNGKey(5)
        _, mask, t = jmasking(rng, jnp.asarray(batch["tokens"]),
                              cfg.mask_id)
        masking = (torch.from_numpy(np.array(mask)),
                   torch.from_numpy(np.array(t)))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        out[key] = (cfg, _jax_step(cfg, params, jb, rng,
                                   jloss.diffusion_loss),
                    _port_step(cfg, params, batch, tloss.diffusion_loss,
                               masking))
    return out


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_diffusion_loss_and_grads_match_jax(diffusion_runs, key):
    cfg, (jl, jm, jg, _, _), (tl, tm, tg, _, _) = diffusion_runs[key]
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    for name in ("ce", "aux", "mask_frac"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]), **TOL)
    if key == "moe":        # the aux loss is in the total
        assert float(tm["aux"]) > 0
        np.testing.assert_allclose(
            float(tl), float(tm["ce"]) + cfg.moe.router_aux_weight
            * float(tm["aux"]), rtol=1e-6)
    jgl, tgl = _leaves(jax.tree.map(np.asarray, jg)), _leaves(tg)
    assert sorted(jgl) == sorted(tgl)
    for name, g in jgl.items():
        np.testing.assert_allclose(np32(tgl[name]), g, err_msg=name, **TOL)


@pytest.mark.parametrize("key", sorted(ARCHS))
def test_one_adamw_update_matches_jax(diffusion_runs, key):
    _, (_, _, _, jnew, jstate), (_, _, _, tnew, tstate) = \
        diffusion_runs[key]
    assert int(tstate.step) == int(jstate.step) == 1
    for jt_, tt_ in ((jnew, tnew), (jstate.mu, tstate.mu),
                     (jstate.nu, tstate.nu)):
        jl, tl = _leaves(jax.tree.map(np.asarray, jt_)), _leaves(tt_)
        for name, a in jl.items():
            np.testing.assert_allclose(np32(tl[name]), a, err_msg=name,
                                       **TOL)


def test_encoder_loss_matches_jax():
    """HuBERT (audio frames, learned positions, no rope, plain GELU MLP):
    ``encoder_loss`` and its grads with the JAX frame mask passed in."""
    cfg = reduced(get_arch("hubert-xlarge"), n_layers=2)
    tcfg = port_cfg(cfg)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    batch = next(jdata.token_batches(cfg, 2, 16, seed=1))
    rng = jax.random.PRNGKey(3)
    k_m, _ = jax.random.split(rng)
    mask = np.array(jax.random.uniform(k_m, (2, 16)) < 0.3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (jl, jm), jg = jax.jit(
        jax.value_and_grad(jloss.encoder_loss, has_aux=True),
        static_argnums=(1,))(params, cfg, jb, rng)
    tp = port_params(params, tcfg)
    leaves = topt.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = tloss.encoder_loss(tp, tcfg, _tbatch(batch),
                                masking=torch.from_numpy(mask))
    tg = topt.tree_unflatten(tp, [
        torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves, torch.autograd.grad(tl, leaves, allow_unused=True))])
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    np.testing.assert_allclose(float(tm["mask_frac"]),
                               float(jm["mask_frac"]), rtol=1e-6)
    tgl = _leaves(tg)
    for name, g in _leaves(jax.tree.map(np.asarray, jg)).items():
        np.testing.assert_allclose(np32(tgl[name]), g, err_msg=name, **TOL)
    assert "pos_embed" in tgl and float(tgl["pos_embed"].abs().sum()) > 0


def test_grad_accumulation_matches_jax_and_the_full_batch():
    """4 interleaved microbatches (row j of microbatch i is global row
    j*4 + i): the port's step equals the JAX step given each JAX
    microbatch's masking, and its accumulated gradients equal the port's
    full-batch gradients."""
    base = reduced(get_arch("internlm2-1.8b"), n_layers=2)
    cfg = dataclasses.replace(base, microbatch=4)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    batch = next(jdata.token_batches(cfg, 8, 16, seed=2))
    rng = jax.random.PRNGKey(9)
    opt_cfg = jopt.AdamWConfig(**OPT)
    jnew, _, jm = jtrainer.train_step(
        params, jopt.init_opt_state(params),
        {"tokens": jnp.asarray(batch["tokens"])}, rng, cfg=cfg,
        opt_cfg=opt_cfg)
    toks = batch["tokens"].reshape(2, 4, -1)
    mask = np.zeros((2, 4, 16), bool)
    t = np.zeros((2, 4), np.float32)
    for i in range(4):
        _, m, ti = jmasking(jax.random.fold_in(rng, i),
                            jnp.asarray(toks[:, i]), cfg.mask_id)
        mask[:, i], t[:, i] = np.asarray(m), np.asarray(ti)
    masking = (torch.from_numpy(mask.reshape(8, 16)),
               torch.from_numpy(t.reshape(8)))
    tcfg = port_cfg(cfg)
    tp = port_params(params, tcfg)
    grads = {}
    for nm in (4, 1):
        grads[nm] = ttrainer.batch_grads(
            tp, _tbatch(batch), cfg=dataclasses.replace(tcfg, microbatch=nm),
            masking=masking)
    for g4, g1 in zip(*(grads[nm][0] for nm in (4, 1))):
        np.testing.assert_allclose(g4.numpy(), g1.float().numpy(),
                                   rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(grads[4][1]["loss"]),
                               float(grads[1][1]["loss"]), rtol=1e-5)
    new, state, tm = ttrainer.train_step(
        tp, topt.init_opt_state(tp), _tbatch(batch), cfg=tcfg,
        opt_cfg=topt.AdamWConfig(**OPT), masking=masking)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), **TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **TOL)
    tl = _leaves(new)
    for name, a in _leaves(jax.tree.map(np.asarray, jnew)).items():
        np.testing.assert_allclose(np32(tl[name]), a, err_msg=name, **TOL)


def test_lr_schedule_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=10, total_steps=100)
    j, t = jopt.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    steps = (0, 1, 9, 10, 50, 99, 150)
    want = [float(jopt.lr_at(j, jnp.asarray(s))) for s in steps]
    got = [float(topt.lr_at(t, torch.tensor(s))) for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] < got[2] and got[2] >= got[4] >= got[5]
    assert got[5] >= t.lr * t.min_lr_ratio * 0.99


def test_adamw_reduces_quadratic_and_skips_nonfinite():
    """The JAX quadratic; then a NaN gradient zeroes the step's gradients
    (the moments only decay) and is flagged, as in JAX."""
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=1000,
                           weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = topt.init_opt_state(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = topt.adamw_update(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.3
    # copies: the port updates in place, and JAX may alias numpy memory
    jparams = {"w": jnp.asarray(params["w"].numpy().copy())}
    jstate = jopt.OptState(jnp.asarray(int(state.step), jnp.int32),
                           {"w": jnp.asarray(state.mu["w"].numpy().copy())},
                           {"w": jnp.asarray(state.nu["w"].numpy().copy())})
    bad = {"w": torch.tensor([float("nan"), 1.0])}
    params, state, m = topt.adamw_update(cfg, params, bad, state)
    jp, js, jm = jopt.adamw_update(
        jopt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=1000,
                         weight_decay=0.0), jparams,
        {"w": jnp.asarray([np.nan, 1.0], jnp.float32)}, jstate)
    assert float(m["nonfinite_grads"]) == float(jm["nonfinite_grads"]) == 1
    np.testing.assert_allclose(params["w"].numpy(), np.asarray(jp["w"]),
                               rtol=1e-6)
    np.testing.assert_allclose(state.mu["w"].numpy(), np.asarray(js.mu["w"]),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "hubert-xlarge",
                                  "internvl2-76b"])
def test_token_batches_equal_jax(arch):
    cfg = reduced(get_arch(arch))
    tcfg = port_cfg(cfg)
    jit_, tit = (jdata.token_batches(cfg, 3, 40, seed=4),
                 tdata.token_batches(tcfg, 3, 40, seed=4))
    for _ in range(2):
        jb, tb = next(jit_), next(tit)
        assert sorted(jb) == sorted(tb)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k])
            assert tb[k].dtype == jb[k].dtype


def test_text_batches_and_byte_tokenizer_equal_jax():
    cfg = reduced(get_arch("internlm2-1.8b"))
    tcfg = port_cfg(cfg)
    corpus = "masked diffusion decodes in any order. " * 8
    jt_, tt_ = jdata.ByteTokenizer(512), tdata.ByteTokenizer(512)
    np.testing.assert_array_equal(tt_.encode(corpus, 32),
                                  jt_.encode(corpus, 32))
    assert tt_.decode(tt_.encode("héllo")) == jt_.decode(jt_.encode("héllo"))
    jb = next(jdata.text_batches(cfg, corpus, 2, 24, seed=1))
    tb = next(tdata.text_batches(tcfg, corpus, 2, 24, seed=1))
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])
    gen = tdata.SyntheticTokens(256, seed=0)
    batch = gen.batch(4, 64)
    assert batch.shape == (4, 64) and batch.max() < 256


def test_trainer_fit_loss_falls():
    """The port's ``Trainer`` on the JAX ``test_training.py`` tiny config
    (vocab 64, d 64, d_ff 128) for its 160 steps: the loss on a held-out
    batch under one fixed masking falls (the training losses themselves
    swing with each step's masking ratio)."""
    cfg = port_cfg(reduced(get_arch("internlm2-1.8b"), vocab_size=64,
                           d_model=64, d_ff=128))
    tr = ttrainer.Trainer(cfg, topt.AdamWConfig(lr=3e-3, warmup_steps=5,
                                                total_steps=180),
                          device="cpu").init(0)
    held = _tbatch(next(tdata.token_batches(cfg, 64, 32, seed=99)))
    mask = torch.from_numpy(np.random.default_rng(5).random((64, 32)) < 0.5)
    t = torch.full((64,), 0.5)

    def held_loss():
        with torch.no_grad():
            return float(tloss.diffusion_loss(tr.params, cfg, held,
                                              masking=(mask, t))[0])

    before = held_loss()
    hist = tr.fit(tdata.token_batches(cfg, 8, 32, seed=0), n_steps=160,
                  log_every=0)
    assert len(hist["loss"]) == 160 and np.isfinite(hist["loss"]).all()
    assert held_loss() < before - 0.05


def test_train_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import train as tlaunch
    assert tlaunch.main(["--arch", "qwen3-moe-235b-a22b", "--device", "cpu",
                         "--steps", "2", "--batch", "2", "--seq", "16"]) == 0
    out = capsys.readouterr().out
    assert "step    0 loss" in out and out.rstrip().endswith("done")
