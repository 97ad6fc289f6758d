"""PyTorch port vs the JAX package: the projection-free drift score and
the wide-rank identification.

1. ``cosine_drift_plain`` (what the port runs on the CPU, and the oracle
   its CUDA kernel is held to on the card) equals the JAX Pallas
   ``cosine_drift`` in interpret mode and the XLA ``strategy.score``, for
   every pairing of f32 and bf16 operands (the incremental identifier
   scores an f32 x against a bf16 cache), at widths 8 to 320 and a ragged
   N.  Tolerance 1e-6 absolute: both compute in f32 and differ only in
   the order of the three sums (cosines lie in [-1, 1]).
2. ``cosine_drift_paged_plain`` equals the JAX Pallas
   ``cosine_drift_paged`` (interpret) and the XLA paged ``score_drift`` to
   the same 1e-6, and the port's own dense ``cosine_drift_plain`` on the
   gathered pages bit for bit (zero page, short rows).
3. Wide-rank identification (r > 256, the value / query / key
   identifiers): ``proxy_score_plain`` and ``proxy_score_paged_plain``
   equal the JAX XLA ``project`` + ``score`` (dense and through a page
   table).  f32: p within 1e-5, scores within 1e-5; bf16: p within one
   bf16 ulp (2^-7 relative: the two round the f32 sum to bf16 after
   summing in a different order), scores within 5e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.strategy import AttnOutCache as JAttnOut
from repro.core.strategy import ValueProxyCache as JValue
from repro.kernels import proxy_score as jps
from repro.kernels.backend import XLA_BACKEND

from _torch_parity import np32
from repro_torch.core.strategy import ValueProxyCache as TValue
from repro_torch.kernels import backend as tbackend
from repro_torch.kernels import proxy_score as tps
from repro_torch.kernels import scatter_update as tsc

torch.set_num_threads(1)
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PAGE = 4
PT = np.asarray([[1, 2, 0, 0, 0], [3, 4, 5, 6, 7], [9, 8, 0, 10, 0]],
                np.int32)


def _rand(rng, shape, dtype, scale=1.0):
    """Random jax array of ``dtype`` and the same values in torch."""
    j = jnp.asarray(rng.standard_normal(shape) * scale, dtype)
    return j, torch.from_numpy(np32(j)).to(_TORCH[dtype])


DTYPES = [("float32", "float32"), ("float32", "bfloat16"),
          ("bfloat16", "bfloat16"), ("bfloat16", "float32")]


@pytest.mark.parametrize("r", [8, 128, 320])
@pytest.mark.parametrize("x_dtype,pc_dtype", DTYPES)
def test_cosine_drift_matches_jax(x_dtype, pc_dtype, r):
    rng = np.random.default_rng(r)
    jx, tx = _rand(rng, (2, 37, r), x_dtype)
    jpc, tpc = _rand(rng, (2, 37, r), pc_dtype)
    # some rows unchanged (cosine 1) and one all-zero row (the eps floor)
    jpc = jpc.at[:, :5].set(jx[:, :5].astype(pc_dtype))
    tpc[:, :5] = tx[:, :5].to(tpc.dtype)
    jx, tx = jx.at[1, 9].set(0), tx.index_put_((torch.tensor(1),
                                                torch.tensor(9)),
                                               torch.tensor(0.0,
                                                            dtype=tx.dtype))
    got = tps.cosine_drift_plain(tx, tpc)
    assert got.dtype == torch.float32 and got.shape == (2, 37)
    want = jps.cosine_drift(jx, jpc, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    xla = JValue(projection="attn_in").score(jx, jpc)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=0,
                               atol=1e-6)
    assert float(got[1, 9]) == 0.0
    # the wrapper takes the plain version for CPU tensors
    assert torch.equal(tps.cosine_drift(tx, tpc), got)


@pytest.mark.parametrize("x_dtype,pc_dtype", DTYPES)
def test_cosine_drift_paged_matches_jax(x_dtype, pc_dtype):
    rng = np.random.default_rng(7)
    r = 24
    n = PT.shape[1] * PAGE
    jx, tx = _rand(rng, (3, n, r), x_dtype)
    ja, ta = _rand(rng, (11, PAGE, r), pc_dtype)
    ja, ta = ja.at[0].set(0), ta.index_fill_(0, torch.tensor([0]), 0)
    pt = torch.from_numpy(PT)
    got = tps.cosine_drift_paged_plain(tx, ta, pt)
    dense = tps.cosine_drift_plain(tx, tsc.gather_pages_plain(ta[None],
                                                              pt)[0])
    assert torch.equal(got, dense)
    want = jps.cosine_drift_paged(jx, ja, jnp.asarray(PT), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    xla = XLA_BACKEND.score_drift(JAttnOut(), jx, ja,
                                  page_table=jnp.asarray(PT))
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), rtol=0,
                               atol=1e-6)
    assert torch.equal(tps.cosine_drift_paged(tx, ta, pt), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_rank_identification_matches_jax(dtype):
    """r = 320 > FUSED_R_MAX: the value identifier's fused score, dense
    and paged, against the JAX XLA project + score."""
    rng = np.random.default_rng(3)
    d, r = 48, 320
    assert r > tps.FUSED_R_MAX
    n = PT.shape[1] * PAGE
    jx, tx = _rand(rng, (3, n, d), dtype)
    jw, tw = _rand(rng, (d, r), dtype, scale=0.2)
    jpc, tpc = _rand(rng, (3, n, r), dtype)
    ja, ta = _rand(rng, (11, PAGE, r), dtype)
    ja, ta = ja.at[0].set(0), ta.index_fill_(0, torch.tensor([0]), 0)
    pt = torch.from_numpy(PT)
    tol_p = 1e-5 if dtype == "float32" else 2 ** -7
    tol_s = 1e-5 if dtype == "float32" else 5e-3
    jstrat, bp = JValue(), {"wv": jw}
    for j_cached, t_cached, table in ((jpc, tpc, None), (ja, ta, pt)):
        js, jp = XLA_BACKEND.identifier_scores(
            jstrat, bp, None, jx, j_cached,
            page_table=None if table is None else jnp.asarray(PT))
        if table is None:
            s, p = tps.proxy_score_plain(tx, tw, t_cached)
        else:
            s, p = tps.proxy_score_paged_plain(tx, tw, t_cached, table)
        np.testing.assert_allclose(np32(p), np32(jp), rtol=tol_p,
                                   atol=tol_p)
        np.testing.assert_allclose(np32(s), np32(js), rtol=0, atol=tol_s)
        # CudaBackend on CPU tensors: the same plain versions
        got = tbackend.CUDA_BACKEND.identifier_scores(
            TValue(), {"wv": tw}, None, tx, t_cached, page_table=table)
        assert torch.equal(got[0], s) and torch.equal(got[1], p)
