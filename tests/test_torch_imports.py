"""Import hygiene of the PyTorch port and its device rule.

``repro_torch`` imports torch and numpy, never ``jax`` and no module of
the JAX package ``repro``: checked in a fresh interpreter after importing
every submodule.  Entry points run on the card unless the caller names a
device, and without a card they raise instead of running on the CPU.
"""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_arch, reduced
from repro_torch.device import resolve_device

SRC = Path(__file__).resolve().parent.parent / "src"

torch.set_num_threads(1)


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_port_imports_neither_jax_nor_repro():
    mods = _submodules()
    assert {"repro_torch.kernels.backend", "repro_torch.dlm.session",
            "repro_torch.weights", "repro_torch.serving.pool",
            "repro_torch.serving.engine",
            "repro_torch.launch.serve", "repro_torch.models.rglru",
            "repro_torch.kernels.rglru_scan",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.models.ssd", "repro_torch.kernels.ssd_chunk",
            "repro_torch.configs.mamba2_370m", "repro_torch.core.runtime",
            "repro_torch.serving.profiling",
            "repro_torch.training.checkpoint", "repro_torch.models.moe",
            "repro_torch.dlm.loss", "repro_torch.training.optimizer",
            "repro_torch.training.trainer", "repro_torch.data.synthetic",
            "repro_torch.launch.train",
            "repro_torch.configs.mixtral_8x22b",
            "repro_torch.configs.qwen3_moe_235b_a22b",
            "repro_torch.configs.internvl2_76b",
            "repro_torch.configs.hubert_xlarge",
            "repro_torch.launch.mesh", "repro_torch.launch.hlo_cost",
            "repro_torch.launch.dryrun", "repro_torch.launch.hillclimb",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.hints"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
            "print(repr(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_default_device_raises_without_cuda(monkeypatch):
    """No card and no explicit device: the entry points raise."""
    from repro_torch.dlm.session import DecodeSession
    from repro_torch.models import transformer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_arch("internlm2-1.8b"), n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                  vocab_size=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_params(reduced(get_arch("mamba2-370m")), seed=0)
    params = transformer.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeSession(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA is unavailable"):
        resolve_device("cuda")
    sess = DecodeSession(params, cfg, device="cpu")
    assert sess.device.type == "cpu"
    from repro_torch.launch import train as tlaunch
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.trainer import Trainer
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, AdamWConfig()).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--steps", "1"])
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.pool import PagePool
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PagePool(cfg, n_pages=4, page_size=4)
    assert ServingEngine(cfg, params, device="cpu").device.type == "cpu"
    from repro_torch.launch import dryrun, hillclimb
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                     "--out", os.devnull])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hillclimb.main(["--arch", "internlm2-1.8b", "--shape", "decode_32k",
                        "--variant", "baseline", "--profile-store", "",
                        "--out", os.devnull])


def test_kernel_wrappers_build_nothing_on_cpu(monkeypatch):
    """CPU tensors take the plain versions: no library is built or
    loaded and no launch is counted."""
    from repro_torch.kernels import (_lib, proxy_score, rglru_scan,
                                     scatter_update, sparse_attention,
                                     ssd_chunk)

    def no_build():
        raise AssertionError("a CPU call must not build the kernels")

    monkeypatch.setattr(_lib, "load", no_build)
    before = _lib.launch_counts()
    h = torch.randn(1, 6, 8)
    proxy_score.gather_norm(h, torch.tensor([[0, 5]]), torch.zeros(8))
    proxy_score.proxy_score(h, torch.randn(8, 4), torch.randn(1, 6, 4))
    arena, pt = torch.randn(2, 3, 2, 4), torch.tensor([[1, 0, 2]])
    proxy_score.proxy_score_paged(h, torch.randn(8, 4), arena[0], pt)
    dense = scatter_update.gather_pages(arena, pt)
    scatter_update.scatter_pages(arena, pt, dense)
    scatter_update.scatter_rows_paged(arena[0], pt, torch.tensor([[0, 5]]),
                                      torch.randn(1, 2, 4))
    rglru_scan.rglru_scan(torch.rand(1, 6, 8), torch.randn(1, 6, 8))
    ssd_chunk.ssd_chunk_scan(torch.randn(1, 8, 2, 4), torch.rand(1, 8, 2),
                             -torch.rand(1, 8, 2), torch.randn(1, 8, 3),
                             torch.randn(1, 8, 3), 4)
    kv = torch.randn(1, 2000, 1, 8)
    sparse_attention.sparse_attention(     # the banded grid
        torch.randn(1, 4, 2, 8), kv, kv, torch.tensor([[0, 1, 2, 3]]),
        window=16, banded=True, q_span=4)
    assert _lib.launch_counts() == before
