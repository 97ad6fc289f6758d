"""The port's dry run (``repro_torch.launch.dryrun``) against the JAX
package's: the analytic roofline terms and abstract inputs for every
arch x shape x mesh, the skipped combinations' reasons, and the record's
keys (a JAX record is made in a subprocess with 256 forced host devices,
the only way to get JAX's production mesh)."""
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ASSIGNED as J_ASSIGNED
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro_torch.configs import ASSIGNED, SHAPES, get_arch, reduced
from repro_torch.launch import dryrun

torch.set_num_threads(1)

SRC = Path(__file__).resolve().parent.parent / "src"


@pytest.fixture(scope="module")
def jdry():
    """The JAX dry-run module; its import prepends a forced device count
    to XLA_FLAGS, which is put back at once (this process keeps its one
    CPU device)."""
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as mod
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    return mod


MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}


def _meshes(kind):
    sizes = MESHES[kind]
    names, shape = tuple(sizes), tuple(sizes.values())
    try:
        jm = AbstractMesh(shape, names)
    except TypeError:
        jm = AbstractMesh(tuple(zip(names, shape)))
    return types.SimpleNamespace(axis_names=names, shape=sizes), jm


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch", ASSIGNED)
def test_roofline_terms_equal_jax(jdry, arch, mesh_kind):
    mesh, jm = _meshes(mesh_kind)
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    for name in SHAPES:
        shape, jshape = SHAPES[name], J_SHAPES[name]
        assert dryrun.model_flops(cfg, shape) == pytest.approx(
            jdry.model_flops(jcfg, jshape), rel=1e-12, abs=0)
        assert dryrun.analytic_memory_bytes(cfg, shape, mesh) == \
            pytest.approx(jdry.analytic_memory_bytes(jcfg, jshape, jm),
                          rel=1e-12, abs=0)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_input_specs_equal_jax(jdry, arch):
    cfg, jcfg = get_arch(arch), j_get_arch(arch)
    for name in SHAPES:
        t = dryrun.input_specs(cfg, SHAPES[name])
        j = jdry.input_specs(jcfg, J_SHAPES[name])
        assert sorted(t) == sorted(j)
        for k in j:
            assert tuple(t[k].shape) == tuple(j[k].shape), (arch, name, k)
            assert str(t[k].dtype).replace("torch.", "") == str(
                j[k].dtype), (arch, name, k)
            assert t[k].is_meta


def test_assigned_and_shapes_equal_jax():
    assert ASSIGNED == J_ASSIGNED
    assert {k: (s.seq_len, s.global_batch, s.kind)
            for k, s in SHAPES.items()} == {
        k: (s.seq_len, s.global_batch, s.kind) for k, s in J_SHAPES.items()}


def test_skipped_combos_carry_jax_reasons(jdry):
    """An unsupported combination is skipped before any mesh exists, with
    the JAX record's reason, field for field."""
    n = 0
    for arch in ASSIGNED:
        for name in SHAPES:
            for mesh in MESHES:
                from repro_torch.configs import supports_shape
                if supports_shape(get_arch(arch), SHAPES[name]):
                    continue
                t = dryrun.run_one(arch, name, mesh, verbose=False,
                                   device="cpu")
                j = jdry.run_one(arch, name, mesh, verbose=False)
                assert t == j
                assert t["status"] == "skipped"
                n += 1
    assert n == 2 * 7    # long_500k of 6 archs + hubert decode_32k, per mesh


def test_proxy_specs_equal_jax():
    """The abstract proxy stacks: shapes and dtypes of the JAX specs."""
    from repro.core.spa_layer import spa_proxy_specs as j_specs
    from repro_torch.core.spa_layer import spa_proxy_specs
    for arch in ASSIGNED:
        t = spa_proxy_specs(get_arch(arch))
        j = j_specs(j_get_arch(arch))
        assert (t is None) == (j is None), arch
        if j is None:
            continue
        assert sorted(t) == sorted(j)
        for k in j:
            assert tuple(t[k].shape) == tuple(j[k].shape)
            assert str(t[k].dtype).replace("torch.", "") == str(j[k].dtype)
            assert t[k].is_meta


JAX_RECORD = r"""
import json, sys
import jax
from jax.sharding import AxisType
make = jax.make_mesh
# the production mesh with Auto axes, which the JAX hints constrain
jax.make_mesh = lambda shape, axes, **kw: make(
    shape, axes, axis_types=(AxisType.Auto,) * len(axes))
from repro.launch import dryrun
from repro.configs import get_arch, reduced
rec = dryrun.run_one("internlm2-1.8b", "decode_32k", "single",
                     verbose=False,
                     cfg_override=reduced(get_arch("internlm2-1.8b"),
                                          n_layers=1))
print(json.dumps(rec))
"""


@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_record_keys_equal_jax(fake_world):
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", JAX_RECORD], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    j = json.loads(out.stdout.strip().splitlines()[-1])
    assert j["status"] == "ok"
    t = dryrun.run_one("internlm2-1.8b", "decode_32k", "single",
                       verbose=False, device="cpu",
                       cfg_override=reduced(get_arch("internlm2-1.8b"),
                                            n_layers=1))
    assert t["status"] == "ok"
    assert set(t) == set(j) - {"xla_cost_analysis"}
    assert set(t["memory"]) == set(j["memory"])
    assert set(t["collectives"]) == set(j["collectives"])
    for kind in j["collectives"]:
        assert set(t["collectives"][kind]) == set(j["collectives"][kind])
    assert t["n_chips"] == j["n_chips"] == 256
    assert t["model_flops_per_device"] == pytest.approx(
        j["model_flops_per_device"], rel=1e-12)
    assert t["hbm_bytes_per_device"] == pytest.approx(
        j["hbm_bytes_per_device"], rel=1e-12)
