"""PyTorch port vs the JAX package: the Mamba-2 SSD scan, mixer and block.

- ``ssd_chunk_scan_plain`` (what the port runs on the CPU and the oracle
  its CUDA kernel is held to on the card) against the JAX Pallas
  ``ssd_chunk_scan`` in interpret mode, head by head, and against
  ``ref.ssd_chunk_ref``, at the shapes of ``tests/test_kernels_ssd.py``:
  f32 within 5e-4 (that file's tolerance: the chunked and the sequential
  forms sum in other orders), bf16 within 5e-2;
- ``models.ssd.ssd_scan`` (la from dt * a, the backend's scan) and the
  sequential ``ssd_scan_ref`` against the JAX ``ssd_scan`` /
  ``ssd_scan_ref`` at B = 2 and several heads: f32 within 1e-5 (the same
  chunked form, einsums in another order);
- ``_depthwise_conv``, the softplus, ``apply_ssd`` (bidirectional and one
  way; T = 50 pads to the chunk, T = 12 is shorter than it) and a whole
  SSD block (with and without an FFN) on carried weights: 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.kernels import ref as jref
from repro.kernels.ssd_chunk import ssd_chunk_scan as jssd_chunk_scan
from repro.models import ssd as jssd
from repro.models import transformer as jt

from _torch_parity import np32, port_cfg, port_params
from repro_torch.kernels import _lib
from repro_torch.kernels import ssd_chunk as tsc
from repro_torch.kernels.backend import CUDA_BACKEND, TORCH_BACKEND
from repro_torch.models import ssd as tssd
from repro_torch.models import transformer as tt
from repro_torch.weights import to_tensor

torch.set_num_threads(1)
KERNEL = dict(rtol=5e-4, atol=5e-4)
F32 = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, t, h, hd, ds, seed=0):
    """x, dt (softplus of a normal), a [H] < 0, bmat, cmat (numpy f32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, t, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.2).astype(np.float32)
    bm = rng.standard_normal((b, t, ds)).astype(np.float32)
    cm = rng.standard_normal((b, t, ds)).astype(np.float32)
    return x, dt, a, bm, cm


def _in_chunk_la(dt, a, chunk):
    """la = in-chunk cumulative sum of dt * a (resets every chunk)."""
    b, t, h = dt.shape
    steps = dt * a[None, None, :]
    return np.cumsum(steps.reshape(b, t // chunk, chunk, h), axis=2,
                     dtype=np.float32).reshape(b, t, h), steps


@pytest.mark.parametrize("t,hd,ds,chunk", [
    (64, 16, 8, 16), (128, 32, 16, 32), (96, 8, 4, 96),
])
def test_plain_matches_pallas_and_ref(t, hd, ds, chunk):
    x, dt, a, bm, cm = _inputs(2, t, 3, hd, ds)
    la, steps = _in_chunk_la(dt, a, chunk)
    got = tsc.ssd_chunk_scan(*(torch.from_numpy(v)
                               for v in (x, dt, la, bm, cm)), chunk)
    assert got.dtype == torch.float32 and got.shape == x.shape
    for row in range(2):
        for head in range(3):
            args = (jnp.asarray(x[row, :, head]),
                    jnp.asarray(dt[row, :, head]))
            want_k = jssd_chunk_scan(*args, jnp.asarray(la[row, :, head]),
                                     jnp.asarray(bm[row]),
                                     jnp.asarray(cm[row]), chunk=chunk,
                                     interpret=True)
            want_r = jref.ssd_chunk_ref(*args,
                                        jnp.asarray(steps[row, :, head]),
                                        jnp.asarray(bm[row]),
                                        jnp.asarray(cm[row]))
            np.testing.assert_allclose(np32(got[row, :, head]),
                                       np32(want_k), **KERNEL)
            np.testing.assert_allclose(np32(got[row, :, head]),
                                       np32(want_r), **KERNEL)


def test_plain_bf16_matches_pallas():
    """bf16 x, b, c (the main path's), f32 dt and la, bf16 out."""
    t, hd, ds, chunk = 64, 16, 8, 32
    x, dt, a, bm, cm = _inputs(1, t, 2, hd, ds, seed=1)
    la, steps = _in_chunk_la(dt, a, chunk)
    xj, bj, cj = (jnp.asarray(v).astype(jnp.bfloat16) for v in (x, bm, cm))
    got = tsc.ssd_chunk_scan(to_tensor(np.asarray(xj), "cpu"),
                             torch.from_numpy(dt), torch.from_numpy(la),
                             to_tensor(np.asarray(bj), "cpu"),
                             to_tensor(np.asarray(cj), "cpu"), chunk)
    assert got.dtype == torch.bfloat16
    for head in range(2):
        want = jssd_chunk_scan(xj[0, :, head], jnp.asarray(dt[0, :, head]),
                               jnp.asarray(la[0, :, head]), bj[0], cj[0],
                               chunk=chunk, interpret=True)
        want_r = jref.ssd_chunk_ref(xj[0, :, head],
                                    jnp.asarray(dt[0, :, head]),
                                    jnp.asarray(steps[0, :, head]), bj[0],
                                    cj[0])
        for w in (want, want_r):
            np.testing.assert_allclose(np32(got[0, :, head]), np32(w),
                                       rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("t,chunk", [(64, 16), (48, 64), (40, 8)])
def test_ssd_scan_matches_jax(t, chunk):
    """The model's scan (la from dt * a) on both backends and the
    sequential reference, against JAX's ``ssd_scan`` / ``ssd_scan_ref``."""
    x, dt, a, bm, cm = _inputs(2, t, 4, 8, 16, seed=2)
    cs = min(chunk, t)
    want = jssd.ssd_scan(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)), cs)
    want_r = jssd.ssd_scan_ref(*(jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    tin = [torch.from_numpy(v) for v in (x, dt, a, bm, cm)]
    for backend in (TORCH_BACKEND, CUDA_BACKEND):
        got = tssd.ssd_scan(*tin, cs, backend)
        np.testing.assert_allclose(np32(got), np32(want), **F32)
    got_r = tssd.ssd_scan_ref(*tin)
    np.testing.assert_allclose(np32(got_r), np32(want_r), **F32)
    np.testing.assert_allclose(np32(got_r), np32(want), **KERNEL)


def test_wrapper_cpu_takes_the_plain_version(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call must not build the kernels")

    monkeypatch.setattr(_lib, "load", no_build)
    before = _lib.launch_counts()
    x, dt, a, bm, cm = _inputs(1, 32, 2, 8, 4, seed=3)
    la, _ = _in_chunk_la(dt, a, 16)
    args = [torch.from_numpy(v) for v in (x, dt, la, bm, cm)]
    assert torch.equal(tsc.ssd_chunk_scan(*args, 16),
                       tsc.ssd_chunk_scan_plain(*args, 16))
    assert _lib.launch_counts() == before
    with pytest.raises(ValueError, match="multiple"):
        tsc.ssd_chunk_scan(*args, 12)   # 32 % 12: the caller pads
    with pytest.raises(ValueError):
        tsc.ssd_chunk_scan(args[0], args[1][:, :16], *args[2:], 16)


def _mixer(cfg, seed=0):
    """JAX init's mixer weights with non-trivial a_log, dt_bias, d_skip and
    norm_weight (the init's are constants), as numpy and as tensors."""
    p = jssd.init_ssd_params(jax.random.PRNGKey(seed), cfg, jnp.float32)
    rng = np.random.default_rng(seed)
    for name, scale in (("a_log", 0.5), ("dt_bias", 1.0), ("d_skip", 1.0),
                        ("norm_weight", 0.1)):
        p[name] = jnp.asarray(
            (p[name] + scale * rng.standard_normal(p[name].shape))
            .astype(np.float32))
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def _cfg():
    return reduced(get_arch("mamba2-370m"), n_layers=2)


def test_conv_and_softplus_match_jax():
    cfg = _cfg()
    jp, tp = _mixer(cfg)
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 30, jp["conv_kernel"].shape[1])
                            ).astype(np.float32)
    want = jssd._depthwise_conv(jnp.asarray(x), jp["conv_kernel"])
    got = tssd._depthwise_conv(torch.from_numpy(x), tp["conv_kernel"])
    np.testing.assert_allclose(np32(got), np32(want), rtol=1e-6, atol=1e-6)
    # XLA flushes the subnormal softplus(-100) = 3.9e-44 to zero
    v = np.array([-100.0, -20.0, -3.0, -1e-3, 0.0, 1e-3, 3.0, 20.0, 100.0],
                 np.float32)
    np.testing.assert_allclose(np32(tssd._softplus(torch.from_numpy(v))),
                               np32(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-37)


@pytest.mark.parametrize("t", [50, 12, 64])
@pytest.mark.parametrize("bidirectional", [True, False])
def test_apply_ssd_matches_jax(t, bidirectional):
    cfg = _cfg()
    jp, tp = _mixer(cfg, seed=1)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    want = jssd.apply_ssd(jp, jnp.asarray(x), cfg, bidirectional)
    for backend in (None, TORCH_BACKEND):
        got = tssd.apply_ssd(tp, torch.from_numpy(x), port_cfg(cfg),
                             bidirectional, backend=backend)
        np.testing.assert_allclose(np32(got), np32(want), **F32)


class _CountingBackend:
    """Counts ssd_scan calls on top of the plain version."""

    def __init__(self):
        self.calls = 0

    def ssd_scan(self, *args):
        self.calls += 1
        return TORCH_BACKEND.ssd_scan(*args)


@pytest.mark.parametrize("d_ff", [0, 64])
def test_ssd_block_matches_jax(d_ff):
    """One SSD transformer block (norm1 -> mixer -> residual, plus norm2 ->
    FFN -> residual when d_ff > 0) on the JAX init's weights; it keeps no
    cache entries, and its scan goes through the strategy's backend, one
    launch per direction."""
    from repro_torch.core.strategy import NoCache
    cfg = dataclasses.replace(_cfg(), d_ff=d_ff)
    params = jt.init_params(cfg, jax.random.PRNGKey(2))
    tcfg = port_cfg(cfg)
    tparams = port_params(params, tcfg)
    assert sorted(tparams["blocks"]["ssd"]) == sorted(
        params["blocks"]["ssd"])
    rng = np.random.default_rng(9)
    h = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    bp = jax.tree.map(lambda t: t[0], params["blocks"]["ssd"])
    want, _, entries = jt.apply_block_dense(cfg, "ssd", bp, jnp.asarray(h),
                                            collect_cache=True)
    assert entries is None
    counter = _CountingBackend()
    strat = dataclasses.replace(NoCache(), backend=counter)
    got, t_entries = tt.apply_block_dense(tcfg, "ssd",
                                          tt.layer_params(tparams, tcfg, 0),
                                          torch.from_numpy(h),
                                          collect_cache=True, strategy=strat)
    assert t_entries is None
    assert counter.calls == 2
    np.testing.assert_allclose(np32(got), np32(want), **F32)
