"""The port's dry run traced on the fake 256-rank mesh (16 x 16), with
reduced configs: train, prefill and decode of a dense (InternLM2), a MoE
(Mixtral) and a recurrent (Mamba2) arch come back ``ok``, their argument
bytes equal the local shards of the JAX rules' specs summed leaf by leaf,
and the sharded steps move bytes between devices.

The fake process group is process-global: the module makes it once and
destroys it at teardown (other files may run in this worker)."""
import math

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.distributed import sharding as jshd
from repro_torch.configs import SHAPES, get_arch, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)

ARCHS = ["internlm2-1.8b", "mixtral-8x22b", "mamba2-370m"]


@pytest.fixture(scope="module")
def mesh():
    m = mesh_lib.make_production_mesh(device_type="cpu")
    yield m
    mesh_lib.destroy_mesh()


def _jax_mesh():
    try:
        return AbstractMesh((16, 16), ("data", "model"))
    except TypeError:
        return AbstractMesh((("data", 16), ("model", 16)))


def _local_bytes(t, spec, jm):
    """Bytes of one device's shard of ``t`` under a JAX spec."""
    spec = tuple(spec) + (None,) * (t.dim() - len(spec))
    n = 1
    for size, entry in zip(t.shape, spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else entry)
        n *= size // math.prod(jm.shape[a] for a in axes)
    return n * t.element_size()


def _jax_rule_arg_bytes(cfg, shape_name):
    """The step's arguments' local bytes, each leaf's spec taken from the
    JAX package's rules on an AbstractMesh (independent of the port's)."""
    jm = _jax_mesh()
    shape = SHAPES[shape_name]
    params = dryrun.abstract_params(cfg)
    total = 0

    def walk(tree, path, fn):
        nonlocal total
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,), fn)
        elif isinstance(tree, torch.Tensor):
            total += _local_bytes(tree, fn(path, tree), jm)

    def param_spec(path, leaf):
        if not cfg.tp_weights:
            return ()
        return jshd.param_pspec(path[-1], leaf, jm, zero3=cfg.zero3,
                                stacked="blocks" in path)

    walk(params, (), param_spec)
    kind = shape.kind
    if kind == "train":
        for path, t in _leaves(params):        # mu and nu, f32
            local = _local_bytes(t, param_spec(path, t), jm)
            total += 2 * 4 * (local // t.element_size())
        total += 4                             # the step count
        full = cfg.moe is None
        walk(dryrun.input_specs(cfg, shape), (), lambda p, leaf:
             jshd.data_pspec(shape, jm, leaf.dim(), full=full))
    elif kind == "prefill":
        full = cfg.moe is None
        walk(dryrun.input_specs(cfg, shape), (), lambda p, leaf:
             jshd.data_pspec(shape, jm, leaf.dim(), full=full))
    else:
        st = dryrun.abstract_decode_state(cfg, shape, dryrun._strategy(cfg))
        walk({"t": st.tokens, "a": st.active}, (), lambda p, leaf:
             jshd.data_pspec(shape, jm, 2))
        walk(st.cache, (), lambda p, leaf: jshd.cache_pspec(shape, jm,
                                                            leaf.dim()))
        walk({"c": st.committed, "n": st.n_masked}, (), lambda p, l: ())
    if kind != "train":
        walk(dryrun.spa_proxy_specs(cfg, dryrun._strategy(cfg)) or {}, (),
             lambda p, leaf: ())
    return total


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_one_ok(mesh, arch, shape_name):
    cfg = reduced(get_arch(arch))
    rec = dryrun.run_one(arch, shape_name, "single", verbose=False,
                         cfg_override=cfg, device="cpu")
    assert rec["status"] == "ok"
    assert rec["n_chips"] == 256
    mem = rec["memory"]
    assert mem["argument_bytes"] == _jax_rule_arg_bytes(cfg, shape_name)
    assert mem["output_bytes"] > 0 and mem["temp_bytes"] >= 0
    assert rec["hlo_flops_per_device"] > 0
    assert rec["hlo_io_bytes_per_device"] > 0
    if (arch, shape_name) == ("mamba2-370m", "prefill_32k"):
        # replicated weights and no cache to build: a data-parallel
        # forward that moves nothing between devices
        assert rec["collective_bytes_per_device"] == 0
    else:
        assert rec["collective_bytes_per_device"] > 0
    assert rec["bottleneck"] in ("t_compute_s", "t_memory_s",
                                 "t_collective_s")
    assert rec["useful_flop_ratio"] > 0


def test_int8_cache_holds_less(mesh):
    """The int8 cache's decode state is smaller per device than the f32
    one (the hill-climb's int8_cache variant)."""
    import dataclasses
    cfg = reduced(get_arch("internlm2-1.8b"))
    base = dryrun.run_one("internlm2-1.8b", "decode_32k", "single",
                          verbose=False, cfg_override=cfg, device="cpu")
    q = dryrun.run_one("internlm2-1.8b", "decode_32k", "single",
                       verbose=False, device="cpu",
                       cfg_override=dataclasses.replace(
                           cfg, cache_dtype="int8"))
    assert q["memory"]["argument_bytes"] < base["memory"]["argument_bytes"]
    assert q["memory"]["per_device_total_gb"] < \
        base["memory"]["per_device_total_gb"]


def test_placements_of_the_arguments(mesh):
    """A cache leaf [Lk, B, N, ...] lies with B over "data" and N over
    "model"; the DTensors the trace builds carry exactly those."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard
    shape = SHAPES["decode_32k"]
    spec = shd.cache_pspec(shape, mesh, 5)
    leaf = torch.empty((2, 128, 32768, 2, 32), device="meta")
    with FakeTensorMode():
        dt = dryrun.distribute(leaf, spec, mesh, torch.device("cpu"))
        assert list(dt.placements) == [Shard(1), Shard(2)]
        assert tuple(dt.to_local().shape) == (2, 8, 2048, 2, 32)
        rep = dryrun.distribute(leaf, None, mesh, torch.device("cpu"))
        assert list(rep.placements) == [Replicate(), Replicate()]
