"""PyTorch port vs the JAX package: flat-npz checkpoints
(``training/checkpoint.py``) and ``serve --ckpt``.

* a checkpoint the JAX package saved (bf16, f32 and int32 leaves, a list)
  loads in the port as the same arrays, and one the port saved (torch and
  numpy leaves) loads in the JAX package; both write the same keys and
  dtype tags;
* a JAX parameter checkpoint becomes the port's parameters through
  ``weights.from_numpy_params``;
* ``serve --ckpt`` of the port decodes what the JAX launcher decodes from
  the same file.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch, reduced
from repro.launch import serve as jserve
from repro.models import transformer as jt
from repro.training import checkpoint as jckpt

from _torch_parity import np32, port_cfg
from repro_torch import weights
from repro_torch.launch import serve as tserve
from repro_torch.training import checkpoint as tckpt

torch.set_num_threads(1)


def _jax_tree():
    rng = np.random.default_rng(0)
    return {
        "w": jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16),
        "b": jnp.asarray(rng.normal(size=(5,)), jnp.float32),
        "steps": jnp.arange(4, dtype=jnp.int32),
        "layers": [{"g": jnp.full((2,), 0.5 * i, jnp.bfloat16)}
                   for i in range(3)],
    }


def _bits(x):
    """Any leaf -> (dtype name, raw bytes) for a bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.numpy().dtype), x.numpy().tobytes()
    a = np.asarray(x)
    return a.dtype.name, a.tobytes()


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    path = str(tmp_path / "j.npz")
    tree = _jax_tree()
    jckpt.save_checkpoint(path, tree, {"step": 7})
    got, meta = tckpt.load_checkpoint(path)
    assert meta == {"step": 7}
    assert isinstance(got["layers"], list) and len(got["layers"]) == 3
    assert got["w"].dtype == torch.bfloat16
    assert got["steps"].dtype == torch.int32
    for want, have in zip(jax.tree.leaves(tree), jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        assert _bits(have) == _bits(want)


def test_port_checkpoint_loads_in_jax(tmp_path):
    tree = _jax_tree()
    ported = {"w": torch.from_numpy(np.array(tree["w"]).view(np.int16))
                   .view(torch.bfloat16),
              "b": torch.from_numpy(np.array(tree["b"])),
              "steps": np.arange(4, dtype=np.int32),       # a numpy leaf
              "layers": [{"g": np.asarray(layer["g"])}     # ml_dtypes bf16
                         for layer in tree["layers"]]}
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tckpt.save_checkpoint(tpath, ported, {"from": "port"})
    jckpt.save_checkpoint(jpath, tree, {"from": "port"})
    got, meta = jckpt.load_checkpoint(tpath)
    assert meta == {"from": "port"}
    for want, have in zip(jax.tree.leaves(tree), jax.tree.leaves(got)):
        assert have.dtype == want.dtype
        assert _bits(have) == _bits(want)
    with np.load(tpath) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        assert json.loads(str(t["__dtypes__"])) == \
            json.loads(str(j["__dtypes__"]))
    # and back into the port, bit for bit
    again, _ = tckpt.load_checkpoint(tpath)
    assert [_bits(x) for x in jax.tree.leaves(
        again, is_leaf=lambda x: isinstance(x, torch.Tensor))] == \
        [_bits(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_parameter_checkpoint_feeds_the_weights_bridge(tmp_path, dtype):
    cfg = reduced(get_arch("internlm2-1.8b"), n_layers=1, d_model=32,
                  n_heads=2, n_kv_heads=1, head_dim=16, d_ff=64,
                  vocab_size=64, param_dtype=dtype)
    params = jt.init_params(cfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "p.npz")
    jckpt.save_checkpoint(path, params)
    tree, _ = tckpt.load_checkpoint(path)
    tparams = weights.from_numpy_params(tree, port_cfg(cfg), "cpu")
    assert tparams["embed"].dtype == getattr(torch, dtype)
    for want, have in zip(jax.tree.leaves(params), jax.tree.leaves(
            tparams, is_leaf=lambda x: isinstance(x, torch.Tensor))):
        np.testing.assert_array_equal(np32(have), np32(want))


def test_serve_ckpt_decodes_what_jax_decodes(tmp_path, capsys):
    """Both launchers serve the same checkpoint of the reduced
    internlm2-1.8b (dense lanes, prefix index off) and print the same
    first tokens of each request."""
    cfg = reduced(get_arch("internlm2-1.8b"))
    path = str(tmp_path / "ckpt.npz")
    jckpt.save_checkpoint(path, jt.init_params(cfg, jax.random.PRNGKey(3)),
                          {"seed": 3})
    argv = ["--arch", "internlm2-1.8b", "--ckpt", path, "--requests", "3",
            "--gen-len", "6", "--canvas", "24", "--max-batch", "2",
            "--no-prefix-cache"]
    outs = []
    for main, extra in ((jserve.main, []), (tserve.main, ["--device", "cpu"])):
        assert main(argv + extra) == 0
        out = capsys.readouterr().out
        assert f"loaded checkpoint {path} ({{'seed': 3}})" in out
        assert "served 3 requests, 18 tokens" in out
        outs.append([ln for ln in out.splitlines()
                     if ln.startswith("  req ")])
    assert len(outs[1]) == 3
    assert outs[1] == outs[0]
