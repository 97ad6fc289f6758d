"""PyTorch port vs the JAX package: selection with deliberate ties.

``jax.lax.top_k`` returns the lowest index first among equal values, and
the JAX package relies on it in three places: the quantized drift top-k
(``select_topk_drift``), the candidate positions (``-inf`` ties when fewer
slots are open than candidates) and the committed-position ring (``-1``
ties).  ``torch.topk`` promises no tie order, so the port sorts stably;
these tests build inputs full of ties and require IDENTICAL indices.
Gathers clamp out-of-range indices and scatters drop them, in both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jsel
from repro.dlm import decoding as jdecoding

from repro_torch.core import selection as tsel
from repro_torch.dlm import decoding as tdecoding

torch.set_num_threads(1)


def _tied_scores(b=3, n=64, seed=0):
    """Many rows at exactly 1.0 (unchanged), runs of equal drift, and
    values closer together than the 1/4096 score quantum."""
    rng = np.random.default_rng(seed)
    s = np.ones((b, n), np.float32)
    s[:, ::3] = 0.5
    s[:, 5:15] = 0.25
    s[:, 20:40:2] = 0.75 + rng.uniform(-1e-5, 1e-5, 10)   # one quantum
    s[1] = rng.choice([0.1, 0.2, 1.0], n)
    return s


@pytest.mark.parametrize("k", [1, 7, 16, 33, 64])
def test_select_topk_drift_ties_match_jax(k):
    s = _tied_scores()
    want = np.asarray(jsel.select_topk_drift(jnp.asarray(s), k))
    got = tsel.select_topk_drift(torch.from_numpy(s), k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    unsorted = np.asarray(jsel.select_topk_drift(jnp.asarray(s), k,
                                                 sort_positions=False))
    np.testing.assert_array_equal(
        tsel.select_topk_drift(torch.from_numpy(s), k,
                               sort_positions=False).numpy(), unsorted)


@pytest.mark.parametrize("ring", [4, 8, 12])
def test_lowest_first_topk_matches_lax_top_k(ring):
    """The commit-ring order: committed positions, -1 everywhere else."""
    rng = np.random.default_rng(1)
    pos = np.full((4, 10), -1, np.int32)
    pos[0, [2, 5]] = [17, 40]
    pos[1, :] = np.arange(10) * 3
    pos[3, 7] = 0
    _, want = jax.lax.top_k(jnp.asarray(pos, jnp.float32), min(ring, 10))
    got = tsel.topk_lowest_first(torch.from_numpy(pos).float(),
                                 min(ring, 10))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    vals = rng.integers(0, 3, (5, 50)).astype(np.float32)   # heavy ties
    _, want = jax.lax.top_k(jnp.asarray(vals), 20)
    np.testing.assert_array_equal(
        tsel.topk_lowest_first(torch.from_numpy(vals), 20).numpy(),
        np.asarray(want))


@pytest.mark.parametrize("n_cand", [4, 16, 40])
def test_candidate_positions_match_jax(n_cand):
    """Fewer open slots than candidates in some rows: the -inf ties fill
    with the lowest closed positions, in JAX's order."""
    rng = np.random.default_rng(2)
    mask_id = 99
    toks = rng.integers(0, 50, (4, 32)).astype(np.int32)
    toks[0, [3, 9, 30]] = mask_id
    toks[1, :] = mask_id
    toks[2, 10:] = mask_id
    active = np.ones((4, 32), bool)
    active[2, :20] = False
    w_idx, w_open = jdecoding._candidate_positions(
        jnp.asarray(toks), mask_id, n_cand, jnp.asarray(active))
    t_idx, t_open = tdecoding._candidate_positions(
        torch.from_numpy(toks), mask_id, n_cand, torch.from_numpy(active))
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(w_idx))
    np.testing.assert_array_equal(t_open.numpy(), np.asarray(w_open))


def test_gather_clamps_and_scatter_drops_like_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, 3)).astype(np.float32)
    idx = np.array([[0, 9, 12, -4], [10, 3, 3, 5]], np.int32)
    np.testing.assert_array_equal(
        tsel.gather_rows(torch.from_numpy(x), torch.from_numpy(idx)).numpy(),
        np.asarray(jsel.gather_rows(jnp.asarray(x), jnp.asarray(idx))))
    rows = rng.standard_normal((2, 4, 3)).astype(np.float32)
    sidx = np.array([[1, 10, -1, 4], [9, 0, 11, 2]], np.int32)
    want = jsel.scatter_rows(jnp.asarray(x), jnp.asarray(sidx),
                             jnp.asarray(rows))
    got = tsel.scatter_rows(torch.from_numpy(x.copy()),
                            torch.from_numpy(sidx), torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,k,nb", [(64, 16, 4), (64, 18, 4), (60, 7, 8),
                                    (64, 3, 4), (64, 64, 2)])
def test_select_stratified_ties_match_jax(n, k, nb):
    """Per-stratum top-(k // nb) with the drift quantum and lowest index
    first among ties: a k that nb does not divide gives (k // nb) * nb
    rows, an nb that does not divide n shrinks to one that does, and
    k < nb still takes one row a stratum."""
    s = _tied_scores(n=n, seed=n + k)
    want = np.asarray(jsel.select_stratified(jnp.asarray(s), k, nb))
    got = tsel.select_stratified(torch.from_numpy(s), k, nb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
