"""The port's cost counter (``repro_torch.launch.hlo_cost``) against the
JAX package's trip-count-aware HLO parser.

The five cases of ``tests/test_hlo_cost.py`` run on the port, the FLOPs
within 1% of JAX ``analyze_hlo`` on the same matmul and within 5% on the
17-trip and 5 x 3 nested loops.  Then the per-device counts of a
row-parallel matmul on a fake (2, 2) mesh, and the dry run's scan and
attention formulas against the plain versions traced step by step.
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.launch.hlo_cost import analyze_hlo
from repro_torch.kernels.rglru_scan import rglru_scan_cost, rglru_scan_plain
from repro_torch.kernels.sparse_attention import (kv_span,
                                                  sparse_attention_cost,
                                                  sparse_attention_plain)
from repro_torch.kernels.ssd_chunk import (ssd_chunk_scan_cost,
                                           ssd_chunk_scan_plain)
from repro_torch.launch import hlo_cost
from repro_torch.launch import mesh as mesh_lib

torch.set_num_threads(1)


def compiled_text(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.fixture(scope="module")
def jax_counts():
    """analyze_hlo of the three JAX programs, once per module."""
    out = {}
    a = jax.ShapeDtypeStruct((128, 256), jnp.float32)
    b = jax.ShapeDtypeStruct((256, 64), jnp.float32)
    out["matmul"] = analyze_hlo(compiled_text(lambda x, y: x @ y, a, b))

    def scan17(w, x):
        def body(h, _):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, None, length=17)
        return h

    out["scan"] = analyze_hlo(compiled_text(
        scan17, jax.ShapeDtypeStruct((64, 64), jnp.float32),
        jax.ShapeDtypeStruct((8, 64), jnp.float32)))

    def nested(w, x):
        def outer(h, _):
            def inner(g, _):
                return g @ w, None
            g, _ = jax.lax.scan(inner, h, None, length=3)
            return g, None
        h, _ = jax.lax.scan(outer, x, None, length=5)
        return h

    out["nested"] = analyze_hlo(compiled_text(
        nested, jax.ShapeDtypeStruct((32, 32), jnp.float32),
        jax.ShapeDtypeStruct((4, 32), jnp.float32)))
    return out


def test_single_matmul_flops(jax_counts):
    res = hlo_cost.analyze(lambda x, y: x @ y, torch.randn(128, 256),
                           torch.randn(256, 64))
    expect = 2 * 128 * 256 * 64
    assert res["flops"] == pytest.approx(expect, rel=0.01)
    assert res["flops"] == pytest.approx(jax_counts["matmul"]["flops"],
                                         rel=0.01)


def test_scan_multiplies_trip_count(jax_counts):
    def fn(w, x):
        h = x
        for _ in range(17):
            h = torch.tanh(h @ w)
        return h

    res = hlo_cost.analyze(fn, torch.randn(64, 64), torch.randn(8, 64))
    assert res["flops"] == pytest.approx(17 * 2 * 8 * 64 * 64, rel=0.05)
    assert res["flops"] == pytest.approx(jax_counts["scan"]["flops"],
                                         rel=0.05)


def test_nested_scans_multiply(jax_counts):
    def fn(w, x):
        h = x
        for _ in range(5):
            for _ in range(3):
                h = h @ w
        return h

    res = hlo_cost.analyze(fn, torch.randn(32, 32), torch.randn(4, 32))
    assert res["flops"] == pytest.approx(5 * 3 * 2 * 4 * 32 * 32, rel=0.05)
    assert res["flops"] == pytest.approx(jax_counts["nested"]["flops"],
                                         rel=0.05)


def test_no_collectives_on_single_device():
    a = torch.randn(16, 16)
    res = hlo_cost.analyze(lambda x: x @ x, a)
    assert res["collective_bytes"] == 0
    assert set(res["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}


def test_bytes_positive():
    a = torch.randn(64, 64)
    res = hlo_cost.analyze(lambda x: torch.tanh(x) + 1, a)
    assert res["bytes_accessed"] >= 64 * 64 * 4
    # views move nothing: a transpose and a reshape add no bytes
    res2 = hlo_cost.analyze(
        lambda x: (torch.tanh(x) + 1).reshape(-1).view(64, 64).t(), a)
    assert res2["bytes_accessed"] == res["bytes_accessed"]


@pytest.fixture(scope="module")
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    mesh_lib._ensure_world("fake", 4)
    yield init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    dist.destroy_process_group()


def test_row_parallel_matmul_per_device(fake_mesh):
    """x [64, 512] (batch over "data", features over "model") @ w [512,
    128] (rows over "model"): each device multiplies its [32, 256] by
    [256, 128] into a partial sum, and the all-reduce over "model" moves
    the local [32, 128] f32 result."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(32, 256), fake_mesh,
                               [Shard(0), Shard(1)], run_check=False,
                               shape=(64, 512), stride=(512, 1))
        w = DTensor.from_local(torch.empty(256, 128), fake_mesh,
                               [Replicate(), Shard(0)], run_check=False,
                               shape=(512, 128), stride=(128, 1))
        with hlo_cost.Analyzer(track_memory=True) as an:
            y = (x @ w).redistribute(fake_mesh, [Shard(0), Replicate()])
        assert list(y.placements) == [Shard(0), Replicate()]
    res = an.result()
    assert res["flops"] == 2 * 32 * 256 * 128
    assert res["collectives"]["all-reduce"] == {"count": 1.0,
                                                "bytes": 32 * 128 * 4.0}
    assert res["collective_bytes"] == 32 * 128 * 4.0
    # operands and result of the local mm, then the all-reduce's result
    assert res["bytes_accessed"] == (32 * 256 + 256 * 128 + 32 * 128) * 4
    assert an.peak >= 32 * 128 * 4


def _counted(fn, *args):
    with torch.no_grad():
        return hlo_cost.analyze(fn, *args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 16), (3, 5, 7)])
def test_rglru_scan_formula(shape, dtype):
    """One fused op: no matrix products, as the step-by-step trace counts
    none; one read of a and x and one write of h, below what the trace
    moves step by step."""
    a = torch.rand(shape).to(dtype)
    x = torch.randn(shape).to(dtype)
    res = _counted(rglru_scan_plain, a, x)
    flops, byts = rglru_scan_cost(shape, a.element_size())
    assert flops == res["flops"] == 0
    assert byts == 3 * a.numel() * a.element_size()
    assert byts <= res["bytes_accessed"]


@pytest.mark.parametrize("dims", [(2, 8, 3, 4, 5, 4), (1, 16, 2, 8, 4, 16),
                                  (2, 12, 4, 4, 3, 4)])
def test_ssd_chunk_scan_formula(dims):
    """The formula's FLOPs equal the plain version's matrix products,
    traced chunk by chunk."""
    b, t, h, hd, ds, chunk = dims
    g = torch.Generator().manual_seed(0)
    x = torch.randn(b, t, h, hd, generator=g)
    dt = torch.rand(b, t, h, generator=g)
    la = -torch.rand(b, t, h, generator=g).cumsum(1)
    bm = torch.randn(b, t, ds, generator=g)
    cm = torch.randn(b, t, ds, generator=g)
    res = _counted(ssd_chunk_scan_plain, x, dt, la, bm, cm, chunk)
    flops, byts = ssd_chunk_scan_cost(tuple(x.shape), ds, chunk, 4)
    assert flops == res["flops"]
    ins = sum(t_.numel() * 4 for t_ in (x, dt, la, bm, cm))
    assert byts == ins + x.numel() * 4
    assert byts <= res["bytes_accessed"]


@pytest.mark.parametrize("case", [
    dict(b=2, kq=5, h=4, kvh=2, d=8, n=40),
    dict(b=1, kq=16, h=2, kvh=1, d=8, n=1100, window=16, banded=True,
         q_span=16),
    dict(b=2, kq=7, h=6, kvh=3, d=4, n=600, window=8)])
def test_attention_formula(case):
    """4 * B * Sq * H * hd * (keys visited): the plain version's two
    products per kv block, summed over its blocks (the banded grid visits
    ``n_band`` blocks per q block)."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(case["b"], case["kq"], case["h"], case["d"],
                    generator=g)
    k = torch.randn(case["b"], case["n"], case["kvh"], case["d"],
                    generator=g)
    v = torch.randn_like(k)
    pos = torch.sort(torch.randperm(case["n"], generator=g)[:case["kq"]]
                     ).values.expand(case["b"], -1)
    window = case.get("window", 0)
    banded, q_span = case.get("banded", False), case.get("q_span", 0)
    from repro_torch.kernels.sparse_attention import band_for
    band = band_for(pos, case["n"], window, q_span, banded=banded)
    assert (band is not None) == banded
    res = _counted(lambda: sparse_attention_plain(q, k, v, pos,
                                                  window=window, band=band))
    span = kv_span(case["n"], window, banded, q_span)
    assert sparse_attention_cost(case["b"], case["kq"], case["h"],
                                 case["d"], span) == res["flops"]
