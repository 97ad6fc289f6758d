"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, over the production mesh shapes.

Every case of ``tests/test_sharding.py`` runs on the port; then every
parameter leaf of the assigned architectures, on both meshes, must get the
JAX rule's spec entry for entry (the JAX side on an ``AbstractMesh``), and
the data and cache specs of every shape likewise.  No process group is
needed: the rules take any object with axis names and sizes.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.distributed import sharding as jshd
from repro.models import transformer as jtransformer
from repro_torch.configs import ASSIGNED, SHAPES, get_arch
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun

torch.set_num_threads(1)


def _abstract_mesh(sizes, names):
    try:
        return AbstractMesh(sizes, names)              # jax >= 0.5
    except TypeError:                                  # jax 0.4.x
        return AbstractMesh(tuple(zip(names, sizes)))


def mesh_single():
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 16, "model": 16})


def mesh_multi():
    return types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                 shape={"pod": 2, "data": 16, "model": 16})


def jax_mesh(mesh):
    return _abstract_mesh(tuple(mesh.shape[a] for a in mesh.axis_names),
                          tuple(mesh.axis_names))


class FakeLeaf:
    def __init__(self, shape):
        self.shape = shape


def _norm(spec, ndim):
    """A spec as a tuple of ``ndim`` entries (a PartitionSpec or a port
    spec; missing trailing entries are replicated)."""
    s = tuple(spec)
    return s + (None,) * (ndim - len(s))


def _sizes_divide(spec, shape, mesh):
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        sz = int(np.prod([mesh.shape[a] for a in axes]))
        assert shape[dim] % sz == 0, (shape, spec)


# ---------------------------------------------------------------------------
# tests/test_sharding.py, case for case, on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
def test_row_column_rules(mesh_fn):
    mesh = mesh_fn()
    spec = shd.param_pspec("wq", FakeLeaf((4096, 2048)), mesh,
                           zero3=False, stacked=False)
    assert spec[0] == "model" and spec[1] is None
    spec = shd.param_pspec("w_up", FakeLeaf((4096, 16384)), mesh,
                           zero3=False, stacked=False)
    assert spec[1] == "model"
    spec = shd.param_pspec("wq", FakeLeaf((24, 4096, 2048)), mesh,
                           zero3=False, stacked=True)
    assert spec[0] is None and spec[1] == "model"


def test_moe_expert_parallel_when_divisible():
    mesh = mesh_single()
    spec = shd.param_pspec("w_gate", FakeLeaf((94, 128, 4096, 1536)),
                           mesh, zero3=True, stacked=True)
    assert spec[1] == "model"       # 128 experts / 16
    spec8 = shd.param_pspec("w_gate", FakeLeaf((56, 8, 6144, 16384)),
                            mesh, zero3=False, stacked=True)
    assert spec8[1] != "model"      # 8 experts not divisible -> TP


def test_indivisible_falls_back():
    mesh = mesh_single()
    spec = shd.param_pspec("embed", FakeLeaf((504, 1280)), mesh,
                           zero3=False, stacked=False)
    _sizes_divide(spec, (504, 1280), mesh)
    assert spec == tuple(jshd.param_pspec(
        "embed", FakeLeaf((504, 1280)), jax_mesh(mesh), zero3=False,
        stacked=False))


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
def test_data_specs_divisible(shape_name, mesh_fn):
    mesh = mesh_fn()
    shape = SHAPES[shape_name]
    spec = shd.data_pspec(shape, mesh, 2)
    _sizes_divide(spec, (shape.global_batch, shape.seq_len), mesh)


@pytest.mark.parametrize("arch", ASSIGNED)
@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
def test_every_param_spec_divisible(arch, mesh_fn):
    cfg = get_arch(arch)
    mesh = mesh_fn()
    abs_params = dryrun.abstract_params(cfg)
    specs = shd.params_shardings(abs_params, cfg, mesh)

    def check(leaf, spec):
        _sizes_divide(spec, tuple(leaf.shape), mesh)
        return leaf

    dryrun._zip_map(check, abs_params, specs)


def test_long_context_shards_sequence():
    spec = shd.data_pspec(SHAPES["long_500k"], mesh_single(), 2)
    assert spec[0] is None and spec[1] is not None


def test_cache_spec():
    spec = shd.cache_pspec(SHAPES["decode_32k"], mesh_single(), 5)
    assert spec[0] is None            # layer stack dim
    assert spec[1] is not None        # batch
    assert spec[2] == "model"         # sequence over model


# ---------------------------------------------------------------------------
# Entry for entry against the JAX rules
# ---------------------------------------------------------------------------

def test_assigned_match_jax():
    assert ASSIGNED == J_ASSIGNED
    assert list(SHAPES) == list(J_SHAPES)


def _jax_param_specs(cfg, mesh):
    """{path: (shape, spec)} from the JAX ``params_shardings``."""
    abs_params = jax.eval_shape(
        lambda k: jtransformer.init_params(cfg, k),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    shardings = jshd.params_shardings(abs_params, cfg, mesh)
    leaves = jax.tree_util.tree_flatten_with_path(abs_params)[0]
    out = {}
    for (path, leaf), sh in zip(leaves, jax.tree_util.tree_leaves(
            shardings)):
        keys = tuple(p.key for p in path)
        out[keys] = (tuple(leaf.shape), _norm(sh.spec, len(leaf.shape)))
    return out


def _port_param_specs(cfg, mesh):
    abs_params = dryrun.abstract_params(cfg)
    specs = shd.params_shardings(abs_params, cfg, mesh)
    out = {}

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], spec[k], path + (k,))
        else:
            out[path] = (tuple(tree.shape), _norm(spec, tree.dim()))

    walk(abs_params, specs, ())
    return out


@pytest.mark.parametrize("arch", ASSIGNED)
@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
def test_param_specs_equal_jax(arch, mesh_fn):
    mesh = mesh_fn()
    j = _jax_param_specs(j_get_arch(arch), jax_mesh(mesh))
    t = _port_param_specs(get_arch(arch), mesh)
    assert set(j) == set(t)
    for path in j:
        assert j[path] == t[path], (arch, path)


@pytest.mark.parametrize("mesh_fn", [mesh_single, mesh_multi])
@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_data_and_cache_specs_equal_jax(shape_name, mesh_fn):
    mesh = mesh_fn()
    jm = jax_mesh(mesh)
    shape, jshape = SHAPES[shape_name], J_SHAPES[shape_name]
    for ndim in (1, 2, 3, 4, 5, 6):
        for full in (True, False):
            assert shd.data_pspec(shape, mesh, ndim, full=full) == _norm(
                jshd.data_pspec(jshape, jm, ndim, full=full), ndim)
    for ndim in (3, 4, 5, 6):          # cache leaves [Lk, B, N, ...]
        assert shd.cache_pspec(shape, mesh, ndim) == _norm(
            jshd.cache_pspec(jshape, jm, ndim), ndim)
    assert shd.batch_axes(mesh) == jshd.batch_axes(jm)
    assert shd.axis_size(mesh, ("data", "model")) == jshd.axis_size(
        jm, ("data", "model"))


def test_rules_take_a_jax_abstract_mesh():
    """Any object with axis names and a size mapping will do."""
    jm = jax_mesh(mesh_multi())
    assert shd.mesh_axes(jm) == {"pod": 2, "data": 16, "model": 16}
    assert shd.param_pspec("wq", FakeLeaf((24, 4096, 2048)), jm,
                           zero3=False, stacked=True) == (None, "model",
                                                          None)


def test_replicated_weights_and_opt_state():
    cfg = get_arch("internlm2-1.8b")
    import dataclasses
    rep = dataclasses.replace(cfg, tp_weights=False)
    abs_params = {"embed": torch.empty((8, 4), device="meta"),
                  "blocks": {"attn": {"wq": torch.empty((2, 4, 4),
                                                        device="meta")}}}
    specs = shd.params_shardings(abs_params, rep, mesh_single())
    assert specs == {"embed": (None, None),
                     "blocks": {"attn": {"wq": (None, None, None)}}}
    opt = shd.opt_state_shardings(None, specs, mesh_single())
    assert opt.step == () and opt.mu is specs and opt.nu is specs


def test_placements():
    """Specs to DTensor placements: one per mesh dim; a dim over two axes
    shards on both, data-major."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                                 shape=(2, 16, 16))
    assert shd.placements((None, "model", None), mesh) == [
        Replicate(), Replicate(), Shard(1)]
    assert shd.placements((("pod", "data", "model"), None), mesh) == [
        Shard(0), Shard(0), Shard(0)]
    assert shd.placements((("pod", "data"), "model"), mesh) == [
        Shard(0), Shard(0), Shard(1)]
    assert shd.local_shape((64, 512, 8), (("pod", "data"), "model", None),
                           mesh) == (2, 32, 8)
