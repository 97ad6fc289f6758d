"""The port's sharding hints (``repro_torch.distributed.hints``) against
the JAX package's.

The JAX side runs ``shard_hint`` with ``hints._current_mesh`` patched to
an ``AbstractMesh`` and ``with_sharding_constraint`` captured, so the spec
it would constrain to is read without devices (the package is not
edited).  The port's ``resolve_spec`` must give that spec on a table of
dims, shapes and meshes, with and without ``batch_axes_ctx``.  On a plain
tensor ``shard_hint`` returns the tensor itself; on a DTensor over a fake
(2, 2) mesh it redistributes, ``"keep"`` keeping a dim's sharding.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.distributed import hints as jhints
from repro_torch.distributed import hints
from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)

MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16},
          "host": {"data": 1, "model": 1}}

DIMS = [
    ("batch", "keep", None),
    ("batch", None, None, None),
    ("batch", "keep", None, None),
    ("batch", "model", None, None),
    ("batch", None, "model", None),
    (None, ("pod", "data", "model"), None),
    ("batch", "model", None),
    ("model", "model"),                      # an axis only once
    (("data", "model"), "data"),
    ("pod", "data"),
    ("batch",),                              # trailing dims replicated
    ("keep", "batch", "model"),
    ("nope", "batch", None),                 # unknown axis: replicated
]

SHAPES = [(128, 32768, 2048), (32, 512, 8, 128), (1, 524288, 4096),
          (8, 20, 4, 64), (4, 16, 3), (256, 4096, 16, 64)]

CTX = [None, ("data",), ("pod", "data"), ("data", "model"),
       ("pod", "data", "model"), ()]


def _abstract_mesh(sizes):
    names, shape = tuple(sizes), tuple(sizes.values())
    try:
        return AbstractMesh(shape, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, shape)))


def _jax_spec(monkeypatch, sizes, shape, dims):
    mesh = _abstract_mesh(sizes)
    captured = []
    monkeypatch.setattr(jhints, "_current_mesh", lambda: mesh)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: captured.append(spec) or x)
    jhints.shard_hint(jax.ShapeDtypeStruct(shape, "float32"), *dims)
    (spec,) = captured
    return tuple(hints.KEEP if e is P.UNCONSTRAINED else e for e in spec)


@pytest.mark.parametrize("ctx", CTX)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_resolved_specs_equal_jax(monkeypatch, mesh, ctx):
    sizes = MESHES[mesh]
    n = 0
    for shape in SHAPES:
        for dims in DIMS:
            if len(dims) > len(shape):
                continue
            with jhints.batch_axes_ctx(ctx), hints.batch_axes_ctx(ctx):
                want = _jax_spec(monkeypatch, sizes, shape, dims)
                got = hints.resolve_spec(shape, dims, sizes)
            assert got == want, (mesh, ctx, shape, dims)
            n += 1
    assert n > 40


def test_plain_tensor_is_returned_itself():
    x = torch.randn(4, 6, 8)
    for dims in DIMS:
        assert hints.shard_hint(x, *dims[:3]) is x
    with hints.batch_axes_ctx(("data",)):
        assert hints.shard_hint(x, "batch", "keep", None) is x


def test_batch_axes_ctx_nests_and_restores():
    sizes = MESHES["multi"]
    shape = (512, 8)
    assert hints.resolve_spec(shape, ("batch",), sizes)[0] == ("pod",
                                                               "data")
    with hints.batch_axes_ctx(("data", "model")):
        assert hints.resolve_spec(shape, ("batch",), sizes)[0] == (
            "data", "model")
        with hints.batch_axes_ctx(()):
            assert hints.resolve_spec(shape, ("batch",), sizes)[0] is None
        assert hints.resolve_spec(shape, ("batch",), sizes)[0] == (
            "data", "model")
    assert hints.resolve_spec(shape, ("batch",), sizes)[0] == ("pod",
                                                               "data")


@pytest.fixture(scope="module")
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    mesh_lib._ensure_world("fake", 4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def _dt(mesh, local, placements, shape):
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=stride)


def test_shard_hint_redistributes_a_dtensor(fake_mesh):
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Partial, Replicate, Shard
    with FakeTensorMode():
        # sequence sharded over "model": "keep" keeps it, None gathers it
        x = _dt(fake_mesh, torch.empty(4, 8, 16), [Shard(0), Shard(1)],
                (8, 16, 16))
        assert hints.shard_hint(x, "batch", "keep", None) is x
        y = hints.shard_hint(x, "batch", None, None)
        assert list(y.placements) == [Shard(0), Replicate()]
        z = hints.shard_hint(x, None, "model", None)
        assert list(z.placements) == [Replicate(), Shard(1)]
        # a partial sum is reduced: "keep" keeps only a Shard
        p = _dt(fake_mesh, torch.empty(4, 16, 16), [Shard(0), Partial()],
                (8, 16, 16))
        q = hints.shard_hint(p, "batch", "keep", None)
        assert list(q.placements) == [Shard(0), Replicate()]
        # an indivisible dim stays replicated
        r = _dt(fake_mesh, torch.empty(3, 16, 16),
                [Replicate(), Replicate()], (3, 16, 16))
        assert list(hints.shard_hint(r, "batch", None, None).placements) \
            == [Replicate(), Replicate()]
