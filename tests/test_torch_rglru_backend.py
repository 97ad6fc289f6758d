"""The RG-LRU recurrence runs on the strategy's backend.

``rglru_scan`` is a backend stage (port-only: the JAX model runs an
associative scan there).  A forward of the reduced 6-layer hybrid through
a strategy on a counting ``TorchBackend`` must call that stage twice per
RG-LRU block (the forward and the flipped direction) and give exactly the
hidden states of ``TORCH_BACKEND``; so the oracle backend never reaches
the CUDA kernel's wrapper.  Parity with the JAX decode is held by
``test_torch_hybrid*.py``.  The port alone, on the CPU.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.configs.base import RGLRU
from repro_torch.core.strategy import SPACache
from repro_torch.kernels import backend as tb
from repro_torch.kernels import rglru_scan as trs
from repro_torch.models import rglru as trglru
from repro_torch.models import transformer as tt

torch.set_num_threads(1)


@dataclasses.dataclass(frozen=True)
class CountingBackend(tb.TorchBackend):
    """TorchBackend that records the shape of each ``rglru_scan`` call."""

    calls: list = dataclasses.field(default_factory=list, compare=False,
                                    hash=False)

    def rglru_scan(self, a, x):
        self.calls.append(tuple(a.shape))
        return super().rglru_scan(a, x)


def _hybrid():
    cfg = reduced(get_arch("recurrentgemma-9b"), n_layers=6)
    params = tt.init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size - 1, (2, 24)))
    return cfg, params, tt.embed_inputs(params, cfg, {"tokens": tokens})


def test_hybrid_forward_scans_on_the_strategys_backend():
    cfg, params, h0 = _hybrid()
    counting = CountingBackend()
    strat = SPACache.from_spec(cfg.spa)
    got, _ = tt.forward_hidden(params, cfg, h0,
                               strategy=strat.with_backend(counting))
    want, _ = tt.forward_hidden(params, cfg, h0,
                                strategy=strat.with_backend("torch"))
    n_rglru = sum(cfg.kind_of_layer(l) == RGLRU for l in range(cfg.n_layers))
    assert n_rglru == 4
    assert counting.calls == [(2, 24, counting_width(cfg))] * (2 * n_rglru)
    assert torch.equal(got, want)


def counting_width(cfg):
    return (cfg.rglru.d_rnn or cfg.d_model) if cfg.rglru else cfg.d_model


def test_rglru_mixer_takes_the_backend_and_defaults_to_cuda():
    """One-way mixer: one stage call; without a backend the mixer runs
    ``CUDA_BACKEND``, whose stage takes the plain loop for CPU tensors."""
    cfg, params, h0 = _hybrid()
    mixer = tt.layer_params(params, cfg, 0)["mixer"]
    counting = CountingBackend()
    one_way = trglru.apply_rglru(mixer, h0, cfg, bidirectional=False,
                                 backend=counting)
    assert len(counting.calls) == 1
    assert torch.equal(one_way, trglru.apply_rglru(
        mixer, h0, cfg, bidirectional=False, backend=tb.TORCH_BACKEND))
    assert torch.equal(trglru.apply_rglru(mixer, h0, cfg),
                       trglru.apply_rglru(mixer, h0, cfg,
                                          backend=tb.TORCH_BACKEND))
    a = torch.rand(2, 9, 8)
    x = torch.randn(2, 9, 8)
    assert torch.equal(tb.CUDA_BACKEND.rglru_scan(a, x),
                       trs.rglru_scan_plain(a, x))
