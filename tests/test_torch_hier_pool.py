"""PyTorch port vs the JAX package: the host-RAM page tier's pieces.

``serving/hier.py`` of both packages on the same blocks: ``page_stability``
within 1e-6; ``HostPagePool``'s half-unit accounting, double-free guard and
slot contents; the int8 representation (codes within 1 of JAX's
``quantize_rows_np``, its f16 scales equal, the round trip within
``max|row|/254`` plus the scale's cast); crc32 checksums equal to JAX's for
identical stored bytes (f32, bf16, int8); ``TierManager`` under f32, int8
and auto against JAX's (representations, units, exactness, checksums,
promoted blocks), host pressure dropping stable pages first; and a
corrupted slot raising ``HostPageCorruption`` with every slot freed.
"""
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.serving import hier as jhier

from repro_torch.serving import hier as thier

torch.set_num_threads(1)
PAGE = 4
SIG = (16, True, True, "float32")


def _t(a):
    """numpy (bf16 included) -> torch, same dtype."""
    a = np.ascontiguousarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _np(t):
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.uint16).numpy().view(
            ml_dtypes.bfloat16)
    return t.contiguous().numpy()


def _blocks(n, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(2, n, PAGE, 6)).astype(dtype)
    v = (rng.normal(size=(2, n, PAGE, 3, 4)) * 3).astype(dtype)
    return {"kv": {"k": k, "v": v}}


def _tblocks(blocks):
    return {kind: {name: _t(b) for name, b in bufs.items()}
            for kind, bufs in blocks.items()}


# ---------------------------------------------------------------------------
# page_stability
# ---------------------------------------------------------------------------

def _stability_cases():
    rng = np.random.default_rng(0)
    d = rng.normal(size=16).astype(np.float32)
    aligned = np.stack([d * s for s in (1.0, 2.0, 0.5, 3.0)])[None]
    half_zero = aligned.copy()
    half_zero[0, :2] = 0.0
    opposed = np.stack([d, -d])[None]
    return {
        "aligned": aligned,
        "noisy": rng.normal(size=(1, 32, 16)).astype(np.float32),
        "layers": rng.normal(size=(3, 4, 8)).astype(np.float32) + 2.0,
        "half_zero": half_zero,
        "opposed": opposed,
        "zeros": np.zeros((1, 4, 16), np.float32),
        "empty": np.zeros((1, 0, 16), np.float32),
        "bf16": (rng.normal(size=(2, 4, 16)) + 1).astype(ml_dtypes.bfloat16),
    }


@pytest.mark.parametrize("case", sorted(_stability_cases()))
def test_page_stability_matches_jax(case):
    block = _stability_cases()[case]
    want = jhier.page_stability(block)
    got = thier.page_stability(_t(block))
    assert abs(got - want) <= 1e-6, (got, want)
    assert 0.0 <= got <= 1.0


def test_batched_stabilities_equal_one_by_one():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 8, 16)).astype(np.float32)
    x[1] = 0.0
    x[2] = x[2, :1]               # parallel rows
    got = thier._stabilities(torch.from_numpy(x)).tolist()
    for i in range(5):
        assert abs(got[i] - jhier.page_stability(x[i])) <= 1e-6


# ---------------------------------------------------------------------------
# HostPagePool
# ---------------------------------------------------------------------------

def test_host_pool_units_and_double_free_match_jax():
    """The JAX test's sequence on both pools: the same accounting after
    every step, and the port's slots hold the stored bytes."""
    jpool, tpool = jhier.HostPagePool(2), thier.HostPagePool(2)
    assert tpool.capacity_units == jpool.capacity_units == 4
    assert not tpool.pin               # pinned only for the card
    seq = [("exact", 2, _blocks(1)), ("int8", 1, _blocks(2, 1)),
           ("exact", 2, _blocks(1, 2))]
    slots = []
    for repr_, units, blk in seq:
        js = jpool.store(SIG, repr_, units, blk)
        ts = tpool.store(SIG, repr_, units, _tblocks(blk))
        assert (js is None) == (ts is None)
        slots.append((js, ts))
        for attr in ("used_units", "used_pages", "peak_units",
                     "utilization"):
            assert getattr(tpool, attr) == getattr(jpool, attr), attr
    assert slots[2] == (None, None)                  # over budget
    got = tpool.load(SIG, "exact", slots[0][1])
    for name in ("k", "v"):
        np.testing.assert_array_equal(_np(got["kv"][name]),
                                      seq[0][2]["kv"][name])
    tpool.free(SIG, "exact", slots[0][1], 2)
    jpool.free(SIG, "exact", slots[0][0], 2)
    assert tpool.used_units == jpool.used_units == 2
    with pytest.raises(AssertionError):
        tpool.free(SIG, "exact", slots[0][1], 2)     # double free
    tpool.free(SIG, "int8", slots[1][1], 1)
    assert tpool.used_units == 0 and tpool.used_pages == 0
    assert tpool.peak_units == 4 and jpool.pages_in == 3
    state = tpool.debug_state()
    assert state["resident_pages"] == 0 and state["unit_budget"] == 4


def test_host_pool_reuses_freed_slots_within_the_budget():
    """Each arena holds the slots the whole budget allows at its rate (2
    exact pages, 4 int8 pages of a 2-page budget) and reuses freed ones."""
    pool = thier.HostPagePool(2)
    a = pool.store(SIG, "exact", 2, _tblocks(_blocks(2)))
    pool.free(SIG, "exact", a, 2)
    b = pool.store(SIG, "exact", 2, _tblocks(_blocks(2, 5)))
    assert sorted(a) == sorted(b) == [0, 1]
    got = pool.load(SIG, "exact", b)
    np.testing.assert_array_equal(_np(got["kv"]["k"]),
                                  _blocks(2, 5)["kv"]["k"])
    pool.free(SIG, "exact", b, 2)
    c = pool.store(SIG, "int8", 1, _tblocks(_blocks(4, 6)))
    assert sorted(c) == [0, 1, 2, 3]


# ---------------------------------------------------------------------------
# int8 representation and checksums
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape,seed", [((8, 16), 0), ((3, 4, 32), 1),
                                        ((2, 5, 4, 16), 2), ((1, 256), 3)])
def test_quantize_rows_matches_jax(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape)
         * 10.0 ** float(rng.integers(-3, 3))).astype(dtype)
    jq, js = jcache.quantize_rows_np(x)
    tq, ts = thier.quantize_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    assert np.abs(tq.numpy().astype(np.int32)
                  - jq.astype(np.int32)).max() <= 1
    np.testing.assert_array_equal(ts.numpy(), js)
    back = thier.dequantize_rows(tq, ts).numpy()
    xf = np.asarray(x, np.float32)
    scale = np.maximum(np.abs(xf).max(-1, keepdims=True) / 127.0, 1e-8)
    bound = (scale * 0.5 + 127 * np.maximum(scale * 2.0 ** -11, 2.0 ** -24)
             + 1e-7)
    assert np.all(np.abs(back - xf) <= bound)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, "int8"])
def test_checksums_match_jax(dtype):
    """The crc32 of a block tree, and of a pool slot holding it, equal the
    JAX package's for the same bytes (the int8 case: a quantized tree)."""
    if dtype == "int8":
        jblk = jhier._quantize_blocks(_blocks(1, 9))
        tblk = thier._quantize_blocks(_tblocks(_blocks(1, 9)))
    else:
        jblk = _blocks(1, 9, dtype)
        tblk = _tblocks(jblk)
    want = jhier._blocks_checksum(jblk)
    assert thier._blocks_checksum(tblk) == want
    pool = thier.HostPagePool(4)
    slot = pool.store(SIG, "exact", 2, tblk)[0]
    assert pool.checksum(SIG, "exact", slot) == want
    pool.corrupt_slot(SIG, "exact", slot)
    assert pool.checksum(SIG, "exact", slot) != want


# ---------------------------------------------------------------------------
# TierManager against JAX's
# ---------------------------------------------------------------------------

def _tiers(n_host, host_dtype, n_pages=16, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(2, n_pages, PAGE, 6)).astype(np.float32)
    tdata = torch.from_numpy(data)

    def jread(sig, pages):
        return {"kv": {"k": data[:, pages], "v": 2.0 * data[:, pages]}}

    def tread(sig, pages):
        return {"kv": {"k": tdata[:, pages], "v": 2.0 * tdata[:, pages]}}

    return (jhier.TierManager(jhier.HostPagePool(n_host),
                              host_dtype=host_dtype, read_pages=jread),
            thier.TierManager(thier.HostPagePool(n_host),
                              host_dtype=host_dtype, read_pages=tread),
            data)


def _proxies(seed=1):
    rng = np.random.default_rng(seed)
    stable = np.repeat(np.ones((1, 1, 8), np.float32), 4, axis=1)
    return {1: stable, 3: stable,
            2: rng.normal(size=(1, 4, 8)).astype(np.float32),
            4: rng.normal(size=(1, 4, 8)).astype(np.float32)}


@pytest.mark.parametrize("host_dtype", ["f32", "int8", "auto"])
def test_tier_demote_promote_matches_jax(host_dtype):
    jt, tt, data = _tiers(8, host_dtype)
    prox = _proxies()
    jt.note_published(SIG, [1, 2, 3, 4], prox)
    tt.note_published(SIG, [1, 2, 3, 4],
                      {p: torch.from_numpy(b) for p, b in prox.items()})
    for p in (1, 2, 3, 4):
        assert abs(tt.stability(p) - jt.stability(p)) <= 1e-6
    jrefs, trefs = jt.demote([1, 2, 3, 4]), tt.demote([1, 2, 3, 4])
    assert [(r.repr_, r.units, r.exact, r.checksum) for r in trefs] == [
        (r.repr_, r.units, r.exact, r.checksum) for r in jrefs]
    assert tt.host.used_units == jt.host.used_units
    jsig, jblk = jt.promote(jrefs)
    tsig, tblk = tt.promote(trefs)
    assert tsig == jsig == SIG
    for name in ("k", "v"):
        got, want = tblk["kv"][name].numpy(), np.asarray(jblk["kv"][name])
        if host_dtype == "f32":
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(
                got, (1.0 if name == "k" else 2.0) * data[:, 1:5])
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert tt.host.used_units == jt.host.used_units == 0
    assert tblk["kv"]["k"].shape[1] == jt.promoted_pages == 4


def test_tier_int8_signature_is_exact_at_the_cold_rate():
    _, tt, _ = _tiers(8, "auto")
    sig8 = (16, True, True, "int8")
    assert tt._repr_for(sig8, 0.0, True) == ("exact", 1, True)
    assert tt._repr_for(SIG, 0.95, True) == ("int8", 1, False)
    assert tt._repr_for(SIG, 0.5, True) == ("exact", 2, True)
    assert tt._repr_for(SIG, 0.5, False) == ("exact", 2, False)


def test_tier_pressure_drops_stable_first_as_jax():
    jt, tt, _ = _tiers(1, "f32")                 # room for one page
    prox = _proxies()
    jt.note_published(SIG, [1, 2, 3], {3: prox[3]})
    tt.note_published(SIG, [1, 2, 3], {3: torch.from_numpy(prox[3])})
    dropped = []
    for pages in ([1], [2], [3], [9]):
        full, stable = jt.dropped_full, jt.dropped_stable
        got = tt.demote(pages)
        assert (got is None) == (jt.demote(pages) is None)
        if got is None:
            dropped.append((pages[0], jt.dropped_full - full,
                            jt.dropped_stable - stable))
    # page 1 takes the room; 2 (unstable) and 3 (stable) drop on a full
    # tier; 9 has no signature
    assert dropped == [(2, 1, 0), (3, 0, 1), (9, 0, 0)]
    assert tt.host.used_units == jt.host.used_units == 2


def test_corrupt_slot_raises_and_frees_the_entry():
    _, tt, _ = _tiers(8, "f32")
    tt.note_published(SIG, [1, 2, 3], None)
    refs = tt.demote([1, 2, 3])
    tt.host.corrupt_slot(SIG, "exact", refs[1].slot)
    with pytest.raises(thier.HostPageCorruption, match="1/3 host pages"):
        tt.promote(refs)
    assert tt.host.used_units == 0 and tt.host.used_pages == 0

